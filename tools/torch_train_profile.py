#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's train steps on one GPU.

Two set-ups, read the same way:
  * the train path of ``chip_smoke.py`` on one fixed batch (full-width
    Swin-L, 6-layer MSDeformAttn pixel decoder, 9-layer decoder, bf16, trunk
    frozen, DropPath 0.3, 12544 grid points, seeded random weights; with
    ``--unfrozen`` its unfrozen path: trunk trained, Swin's window attention
    fused with its output projection; with ``--distill`` the stage-5 step of
    its phase 10: banded sampling and the 22,000 x 8 + 1 column part head,
    two images of classes 4711 and 21999), warmed up by two steps;
  * with ``--loop CONFIG TRAFFIC``, a training loop of the benchmark's files
    ``portbench/configs/CONFIG.json`` and ``portbench/traffic/TRAFFIC.json``
    (``m2f-swinL-supervised supervised_train`` is the ``supervised.train``
    cell, ``m2f-vitdetL-supervised supervised_train`` the ``vitdet.train``
    cell) set up as ``portbench/train.py`` does: the program's
    ``DataLoader`` over the traffic's image set, each batch packed into the
    wire format (``run._pack_train_batch``), the step's noise, then
    ``Trainer.train_step``, after the checked and warm-up steps. It also
    times ``--untraced`` steps on the host clock, counts the fused LN -> MLP's
    and the relative-position attention's forward and backward launches and
    the deformable sampling's backward calls (all, banded) in each, and reads the loader's counters
    (``DataLoader.stats()``) over the traced steps.

Then it traces ``--steps`` steps with ``torch.profiler`` and reads the trace
through the program's spans (``utils/profiling.summarize_trace``):
  * device ms a step in each forward part, the criterion, the backward and
    the optimizer, the backward by the forward part it differentiates and
    by kernel op (the ``bwd.*`` spans, ``ops/autograd.route``);
  * the backward's device ms by op kind under each ``bwd.*`` span and
    outside them;
  * the host ms of every span, such as the matcher's round trip and its
    parts: the wait for the forward and the copy (``matcher.to_host``), the
    host LSAP (``matcher.lsap``), the copy back (``matcher.to_device``); in
    a loop, the wait on the loader's queue (``loader.wait``) and the
    packing (``data.pack``);
  * the device's idle ms by span, its idle share inside the busy span and
    the share under no program span;
  * device time by kernel and by kernel family, and the program's spans a
    step with what one costs with the profiler off.

Prints one JSON line per reading and the card's name and power limit.
Writes the Chrome trace under ``--out``. Run from the repository root:
``python3 tools/torch_train_profile.py [--unfrozen | --distill | --loop CONFIG TRAFFIC]``.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def span_cost_us(n: int = 200_000) -> float:
    """µs one ``record_function`` enter and exit costs with the profiler off."""
    from torch.profiler import record_function

    t = time.perf_counter()
    for _ in range(n):
        pass
    empty = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        with record_function("bwd.x"):
            pass
    return 1e6 * (time.perf_counter() - t - empty) / n


def read_trace(out_dir: Path, steps: int, path: str, card: str) -> list:
    """The readings of the trace ``trace_steps`` wrote into ``out_dir``."""
    from partdistillation_torch.utils.profiling import SPANS, TRACE_SUFFIX, summarize_trace
    from tools.torch_proposal_profile import family

    t = time.perf_counter()
    _, detail = summarize_trace(str(out_dir), steps=steps, return_detail=True)
    read_s = time.perf_counter() - t
    by_span, host, idle = (detail[k] for k in ("device_by_span", "host_by_span",
                                               "idle_by_span"))
    # the backward's device time by op kind under each innermost bwd.* span
    kinds = collections.defaultdict(collections.Counter)
    for scope, ops in detail.items():
        names = scope.split("/")
        if "backward" in names:
            inner = [n for n in names if n.startswith("bwd.")]
            kinds[inner[-1] if inner else "backward"].update(ops)
    lines = [
        {"phase": "train_step_ms", "path": path, "card": card, "steps": steps,
         **{k: by_span.get(k, 0.0) for k in ("backbone", "pixel_decoder",
                                             "transformer_decoder", "criterion", "backward",
                                             "optimizer")},
         "backward_by_scope": detail["backward_by_scope"],
         "backward_by_op": {k: v for k, v in by_span.items() if k.startswith("bwd.")},
         "backward_op_kinds": {k: dict(v.most_common(6)) for k, v in kinds.items()}},
        {"phase": "host_ms", "path": path, "card": card, **host}]

    with open(out_dir / ("steps" + TRACE_SUFFIX)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sum(e.get("cat") == "user_annotation" and e["name"] in SPANS for e in events)
    kernels, fams = {}, {}
    for e in device:
        for table, key in ((kernels, e["name"]), (fams, family(e["name"]))):
            k = table.setdefault(key, [0.0, 0])
            k[0] += e["dur"] / 1e3 / steps
            k[1] += 1
    span_ms = ((max(e["ts"] + e["dur"] for e in device) - min(e["ts"] for e in device))
               / 1e3 / steps if device else None)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    lines.append({
        "phase": "trace", "path": path, "card": card, "steps": steps,
        "busy_span_ms": span_ms, "idle_share": idle["<idle>"] / span_ms if span_ms else None,
        "unattributed_share": idle["<unattributed>"] / idle["<idle>"] if idle["<idle>"] else None,
        "idle_by_span_ms": idle, "summarize_s": read_s,
        "program_spans": spans / steps, "span_cost_off_us": span_cost_us(),
        "kernel_launches": sum(v[1] for v in kernels.values()) // steps,
        "families_ms": {k: round(v[0], 4) for k, v in
                        sorted(fams.items(), key=lambda kv: -kv[1][0])},
        "families_launches": {k: v[1] // steps for k, v in fams.items()},
        "top_kernels": [{"name": n[:90], "ms": round(v[0], 4), "launches": v[1] // steps}
                        for n, v in top]})
    return lines


def profile_loop(cfg: dict, traffic: dict, seed: int, device: str, steps: int, untraced: int,
                 out_dir: Path, path: str, card: str) -> list:
    """The readings of a benchmark configuration's training loop (the
    module docstring's ``--loop``) on ``device``."""
    import torch

    from partdistillation_torch.ops.autograd import launch_counts, reset_launches
    from partdistillation_torch.utils.profiling import trace_steps
    from portbench.train import Session

    tmp = tempfile.mkdtemp()
    sess = Session(cfg, traffic, seed, device, tmp)
    try:
        sess.checked_steps()

        def step():
            _, packed, noise = sess.next_batch()
            sess.step(packed, noise)

        counters = ("fused_ln_mlp", "fused_ln_mlp_backward", "relpos_attention",
                    "relpos_attention_bwd", "msda_folded_bwd", "msda_folded_bwd_banded")
        times, launches = [], []
        for _ in range(untraced):
            reset_launches()
            t = time.perf_counter()
            step()
            times.append(1e3 * (time.perf_counter() - t))
            launches.append(list(launch_counts(*counters).values()))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        before = sess.loader.stats()
        trace_steps(step, str(out_dir), steps=steps, warmup=0)
        after = sess.loader.stats()
    finally:
        sess.close()
        shutil.rmtree(tmp, ignore_errors=True)
    window = {k: after[k] - before[k] for k in after}
    loop = {"phase": "loop", "path": path, "card": card, "seed": seed, "steps": steps,
            "untraced_step_ms": times,
            "untraced_step_ms_median": statistics.median(times) if times else None,
            "ln_mlp_forward_backward_launches": [x[:2] for x in launches],
            "relpos_attn_forward_backward_launches": [x[2:4] for x in launches],
            "msda_backward_banded_launches": [x[4:] for x in launches],
            "loader": window,
            "queue_empty_share": (window["taken_empty"] / window["taken"]
                                  if window["taken"] else None)}
    return [loop, *read_trace(out_dir, steps, path, card)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3, help="traced train steps")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--unfrozen", action="store_true",
                      help="profile chip_smoke.py's unfrozen train path")
    mode.add_argument("--distill", action="store_true",
                      help="profile chip_smoke.py's stage-5 train step (the part head)")
    mode.add_argument("--loop", nargs=2, metavar=("CONFIG", "TRAFFIC"),
                      help="profile the training loop of portbench's CONFIG and TRAFFIC files")
    ap.add_argument("--untraced", type=int, default=10,
                    help="with --loop: steps timed untraced before the trace")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    if args.loop:
        conf, traffic = args.loop
        load = lambda *p: json.loads((ROOT / "portbench").joinpath(*p).read_text())  # noqa: E731
        path = f"{conf}.{traffic}"
        for line in profile_loop(load("configs", conf + ".json"),
                                 load("traffic", traffic + ".json"), args.seed, "cuda",
                                 args.steps, args.untraced, Path(args.out) / f"loop_{path}",
                                 path, card):
            emit(line)
        return 0

    from chip_smoke import (BATCH_SIZE, DISTILL_PARTS, FREEZE_KEYS, IMAGE_SIZE,
                            distill_config, synthetic_train_batch, train_config,
                            unfrozen_config)
    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch import part_distillation, proposal
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.utils.profiling import trace_steps

    rng = np.random.default_rng(args.seed)
    batch = synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE)
    if args.distill:
        cfg, meta, path = distill_config(), part_distillation, "distill"
        batch["labels"] = rng.integers(0, DISTILL_PARTS, batch["valid"].shape).astype(np.int32)
        batch["gt_object_class"] = np.array([4711, 21999][:BATCH_SIZE], np.int32)
    else:
        cfg, meta = (unfrozen_config() if args.unfrozen else train_config()), proposal
        path = "unfrozen" if args.unfrozen else "frozen"
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=args.seed)
    loss_fn = meta.make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model,
                      OptimizerConfig(freeze_keys=() if args.unfrozen else FREEZE_KEYS),
                      device="cuda", seed=args.seed)
    out_dir = Path(args.out) / f"train_step_{path}"
    trace_steps(lambda: trainer.train_step(batch), str(out_dir), steps=args.steps, warmup=2)
    for line in read_trace(out_dir, args.steps, path, card):
        emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
