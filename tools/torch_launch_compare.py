#!/usr/bin/env python3
"""``train-proposal`` as a fresh process, launched plainly and by torchrun at
world 1 (NCCL), in turns: what the launcher and the process group cost.

  python3 tools/torch_launch_compare.py [--steps 8] [--rounds 2] [--seed 0]

Over ``chip_smoke.cli_dataset`` (8 synthetic JPEGs, full-size default: Swin-L
bf16, banded sampling, trunk frozen, B = 2), each round runs ``python -m
partdistillation_torch.run train-proposal`` and then ``python -m
torch.distributed.run --standalone --nproc-per-node 1 -m
partdistillation_torch.run train-proposal`` (the next round in the other
order), each into a checkpoint directory of its own, and prints one JSON
line a run (the CLI's own line: steady img/s, step s, first-batch s) with its
wall seconds, then a summary line with the medians by launcher. The kernel
library is built once first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_launch_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from partdistillation_torch.utils import native_lib

    native_lib.build_library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    launchers = {
        "plain": [sys.executable, "-m", "partdistillation_torch.run"],
        "torchrun_world1": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node=1", "-m", "partdistillation_torch.run"],
    }
    runs = {name: [] for name in launchers}
    with tempfile.TemporaryDirectory() as tmp:
        ov = cs.cli_dataset(tmp, args.seed)
        for r in range(args.rounds):
            order = list(launchers) if r % 2 == 0 else list(reversed(launchers))
            for name in order:
                argv = [*launchers[name], "train-proposal", "--set", *ov,
                        f"data.batch_size={cs.CLI_BATCH}", f"max_iters={args.steps}",
                        "checkpoint_every=1000", f"checkpoint_dir={tmp}/{name}_{r}"]
                t0 = time.perf_counter()
                proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                                      timeout=600)
                wall = time.perf_counter() - t0
                if proc.returncode != 0:
                    print(proc.stderr[-3000:], file=sys.stderr)
                    return 1
                res = json.loads([ln for ln in proc.stdout.splitlines()
                                  if ln.startswith("{")][-1])
                line = {"launcher": name, "round": r, "wall_s": round(wall, 3), **res}
                runs[name].append(line)
                print(json.dumps(line), flush=True)
    print(json.dumps({"summary": {name: {
        key: statistics.median(x[key] for x in lines)
        for key in ("wall_s", "step_s", "loader_wait_s", "images_per_sec_steady",
                    "first_batch_s")}
        for name, lines in runs.items()}, "steps": args.steps, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
