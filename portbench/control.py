"""Readings that the limits of a training cell are set from, on the card:

  python3 portbench/control.py --workload proposal.train --seeds 1 2 3 [--out F]

For each seed, in one process: the program's checked steps (the set-up of a
run, without the window) against the float32 reference, which gives the
numbers a sound run reads; then, in the program's place, the reference
computed with fp8 operands (the control: the next precision below the
configuration's bf16), with fp8 operands in the decoder alone, with bf16
operands (where the configuration's own precision lies), with the loss taken
over half of each batch (the forward on the whole batch, the mean over the
rest), and with one leaf's gradient zeroed, each against the float32
reference. One JSON line per seed; a
step that returns its state unchanged reads 1 in ``change_gap`` and needs no
run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import check, run as bench_run, train  # noqa: E402


# the leaf whose gradient the planted fault zeroes where the backward produces
# it: a decoder cross-attention's projections, which the masked-attention
# backward kernel serves
FAULT_LEAF = ("sem_seg_head.predictor.transformer_cross_attention_layers.1."
              "multihead_attn.in_proj_weight")


def readings(cfg: dict, traffic: dict, seed: int, device, tmp_root=None) -> dict:
    tmp = tempfile.mkdtemp(prefix="portbench-control-", dir=tmp_root)
    try:
        sess = train.Session(cfg, traffic, seed, device, tmp)
        try:
            sess.checked_steps()
        finally:
            sess.close()
        rows, in_gap = sess.reference_rows()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    args = (cfg, seed, rows, sess.kept_noise, device)
    ref = check.run_reference(*args, against=sess.prog.pop("first"), keep=True)
    first = ref.pop("first")
    out = {"seed": seed, "program": check.compare(sess.prog, ref, ref["first_gaps"]),
           "program_worst": check.worst(sess.prog, ref)}
    if in_gap is not None:
        out["program"]["input_gap"] = in_gap
    faults = {"fp8": {"rounding": "fp8"}, "fp8_decoder": {"decoder_rounding": "fp8"},
              "bf16": {"rounding": "bf16"}, "half_batch": {"half_loss": True},
              "zeroed_gradient": {"zero_grad": FAULT_LEAF}}
    for name, kw in faults.items():
        ctl = check.run_reference(*args, against=first, in_program_place=True, **kw)
        out[name] = check.compare(ctl, ref, ctl["first_gaps"])
        if in_gap is not None:
            out[name]["input_gap"] = 0.0  # in the program's place on the reference's rows
        if name == "fp8":
            out["fp8_worst"] = check.worst(ctl, ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = bench_run.load_json(bench_run.ROOT, "BENCHMARK.json")
    _, cfg, traffic, _ = bench_run.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = json.dumps({**readings(cfg, traffic, seed, torch.device("cuda", 0)),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
