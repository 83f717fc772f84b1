#!/usr/bin/env python3
"""Microbenchmark of the port's deformable-sampling kernels on one GPU.

Counterpart of ``tools/msda_bench.py`` and ``tools/msda_folded_bench.py`` of
the JAX package, at the port's full-width geometry (B = 2, 640^2, so
BM = B x 8 heads = 16, Lq = 8400 queries, P = 4 points, D = 32, bf16) on each
of the pixel decoder's three levels (80^2, 40^2, 20^2):

* the P-folded kernel (``ops/msda_sampling.sample_level_folded``,
  ``csrc/msda_folded.cu``) on one level, and
* the per-tap kernel (``ops/msda_sampling.sample_level``,
  ``csrc/msda_taps.cu``, N = Lq x P = 33600 taps), the one kernel for both of
  the JAX package's variants ("expand" and "sel", the same function),

each checked against its plain version (max |err| within 2^-7 of max
|plain|: one bf16 rounding of the output) and timed with CUDA events beside
the plain version, the card's bound (bytes or operations at the H100's
peaks) and the library yardstick: ``F.grid_sample`` (bilinear, zeros
padding, align_corners=False), weighted and summed over the points. The
yardstick takes the map channels-first (B, D, H, W) and a normalised grid,
converted before the timing. ``ms`` and ``library_ms`` are the median of
five reads (each the mean of 20 calls), with their range.

Prints the card's name and power limit, then one JSON line per (level,
kernel). Run from the repository root: ``python3 tools/torch_msda_bench.py``
(``--levels 0`` for the 80^2 level only). ``chip_smoke.py`` drives both at
every level: no model path runs the per-tap kernel.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LEVELS = ((80, 80), (40, 40), (20, 20))
BM, LQ, P, D = 16, 8400, 4, 32
TOL_REL = 2.0 ** -7


def _inputs(g, shape, h, w):
    """Pixel coordinates over the map and 1.5 pixels beyond each edge, and
    weights in [0, 1), f32 on the card."""
    import torch

    x = torch.rand(shape, generator=g, device="cuda") * (w + 3.0) - 2.0
    y = torch.rand(shape, generator=g, device="cuda") * (h + 3.0) - 2.0
    return x, y, torch.rand(shape, generator=g, device="cuda")


def _check(out, ref):
    import torch

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not np.isfinite(err) or err > TOL_REL * scale:
        raise AssertionError(f"kernel vs plain: max_abs_err {err} > {TOL_REL} x {scale}")
    return err, err / scale


def _grid(x, y, h, w):
    """Pixel coordinates (align_corners=False) -> grid_sample's [-1, 1]."""
    import torch

    return torch.stack([(x + 0.5) / w * 2 - 1, (y + 0.5) / h * 2 - 1], -1)


def bench_folded(h: int, w: int, seed: int = 0) -> dict:
    """The P-folded kernel on one level: v (BM, H*W, D), x, y, attw
    (BM, P, Lq)."""
    import torch
    import torch.nn.functional as F

    from partdistillation_torch.ops import msda_sampling as ms
    from partdistillation_torch.utils.timing import PEAK_F32_FLOPS, bound, steady, time_ms

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    v = torch.randn((BM, h * w, D), generator=g, device="cuda").to(torch.bfloat16)
    x, y, a = _inputs(g, (BM, P, LQ), h, w)
    err, rel = _check(ms.sample_level_folded(v, x, y, a, h, w),
                      ms.sample_level_folded_plain(v, x, y, a, h, w))
    v_cf = v.transpose(1, 2).reshape(BM, D, h, w).contiguous()
    grid = _grid(x, y, h, w).to(torch.bfloat16)  # (BM, P, Lq, 2)
    a_bf = a.to(torch.bfloat16)

    def library():
        s = F.grid_sample(v_cf, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (BM, D, P, Lq)
        return (s * a_bf[:, None]).sum(2).transpose(1, 2)

    nbytes = v.numel() * 2 + 3 * x.numel() * 4 + BM * LQ * D * 2
    least, by = bound(nbytes, 8 * D * x.numel(), PEAK_F32_FLOPS)
    return {"kernel": "msda_folded (one level)", "level": [h, w],
            "shape": [BM, P, LQ, D], "max_abs_err": err, "rel_err": rel,
            **steady("", lambda: ms.sample_level_folded(v, x, y, a, h, w)),
            "plain_ms": time_ms(lambda: ms.sample_level_folded_plain(v, x, y, a, h, w)),
            **steady("library_", library), "bound_ms": least, "bound_by": by}


def bench_taps(h: int, w: int, seed: int = 0) -> dict:
    """The per-tap kernel on one level: v_whd (BM, W, H*D), x, y, attw
    (BM, Lq*P). Returns its numbers and ``launches``, the kernel's launches
    that the bench made (its wrapper's count)."""
    import torch
    import torch.nn.functional as F

    from partdistillation_torch.ops import msda_sampling as ms
    from partdistillation_torch.ops.autograd import launch_counts
    from partdistillation_torch.utils.timing import PEAK_F32_FLOPS, bound, steady, time_ms

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n = LQ * P
    v = torch.randn((BM, w, h * D), generator=g, device="cuda").to(torch.bfloat16)
    x, y, a = _inputs(g, (BM, n), h, w)
    v_cf = v.reshape(BM, w, h, D).permute(0, 3, 2, 1).contiguous()  # (BM, D, H, W)
    grid = _grid(x, y, h, w).to(torch.bfloat16)[:, None]  # (BM, 1, N, 2)
    a_bf = a.to(torch.bfloat16)

    def library():
        s = F.grid_sample(v_cf, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # (BM, D, 1, N)
        return (s[:, :, 0] * a_bf[:, None]).transpose(1, 2)

    nbytes = v.numel() * 2 + 3 * BM * n * 4 + BM * n * D * 2
    least, by = bound(nbytes, 8 * D * BM * n, PEAK_F32_FLOPS)
    before = launch_counts("msda_taps")["msda_taps"]
    err, rel = _check(ms.sample_level(v, x, y, a, h, w), ms.sample_level_plain(v, x, y, a, h, w))
    kernel = steady("", lambda: ms.sample_level(v, x, y, a, h, w))
    return {"kernel": "msda_taps", "level": [h, w], "shape": [BM, n, D],
            "max_abs_err": err, "rel_err": rel, **kernel,
            "plain_ms": time_ms(lambda: ms.sample_level_plain(v, x, y, a, h, w)),
            **steady("library_", library), "bound_ms": least, "bound_by": by,
            "launches": launch_counts("msda_taps")["msda_taps"] - before}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 1, 2],
                    help="which levels: 0 = 80^2, 1 = 40^2, 2 = 20^2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_msda_bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for i in args.levels:
        h, w = LEVELS[i]
        print(json.dumps(bench_folded(h, w, args.seed)), flush=True)
        print(json.dumps(bench_taps(h, w, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
