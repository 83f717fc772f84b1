#!/usr/bin/env python3
"""Readings of ``chip_smoke.py``'s phase-14 checks over seeds.

For each seed: the supervised criterion (random point mode, 12544 points, 10
layers, B = 2, T = 8, 200 queries, 160^2 mask logits, f32) on the card
against the CPU on the same inputs, with and without the planted sign fault
(the most certain points kept), and the full-width supervised train step
(trunk unfrozen) through the kernels against the plain versions at the
seeded initial weights. ``chip_smoke.py``'s CRIT_* and SUP_* limits are
about twice the worst sound readings.

Run from the repository root on one GPU:
``python3 tools/torch_supervised_seeds.py --seeds 0 1 2``. Prints the card's
name and power limit, then one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    import torch

    import chip_smoke
    from partdistillation_torch.utils import native_lib

    if not torch.cuda.is_available():
        print("torch_supervised_seeds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    native_lib.load_library()
    for seed in args.seeds:
        crit, planted = chip_smoke.criterion_card_vs_cpu(seed)
        out = {"seed": seed, "criterion": crit, "criterion_sign_flipped": planted}
        torch.cuda.empty_cache()
        out["step"] = chip_smoke.supervised_step_check(seed)
        torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
