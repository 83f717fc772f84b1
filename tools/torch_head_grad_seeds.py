#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s stage-5 head-gradient check over seeds.

For each seed, builds phase 10's synthetic images and stage-4 store and runs
its one-batch check (three images: two of class 4711, one of class 21,999)
at the full-size default: the part head's nonzero gradient rows against the
batch's live columns, and the kernel-vs-plain loss and live-column gradient
(relative error, cosine). Each seed runs ``--repeats`` times: the gather's
backward adds duplicate rows with atomics, so two runs may differ in their
last bits. ``chip_smoke.py``'s HEAD_GRAD_* limits are about twice the
largest readings.

Run from the repository root on one GPU:
``python3 tools/torch_head_grad_seeds.py --seeds 0 1 2 --repeats 2``. Prints
the card's name and power limit, then one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from partdistillation_torch.utils import native_lib

    if not torch.cuda.is_available():
        print("torch_head_grad_seeds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    native_lib.load_library()
    for seed in args.seeds:
        for rep in range(args.repeats):
            with tempfile.TemporaryDirectory() as tmp:
                chip_smoke.cli_dataset(tmp, seed)
                _, items = chip_smoke.stage4_store(tmp, seed)
                out = chip_smoke.head_gradient_check(seed, items)
            torch.cuda.empty_cache()
            print(json.dumps({"seed": seed, "repeat": rep, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
