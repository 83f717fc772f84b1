#!/usr/bin/env python3
"""Device time per launch inside one wrapper call, at every main-path shape
(B=2, 640^2, bf16): the LayerNorm (``csrc/layer_norm.cu``) at its seven
row shapes, the LN -> MLP kernel (``csrc/fused_mlp.cu``: the
LayerNorm pass, the fc1 GEMM and the fc2 GEMM) at its four shapes, its
backward kernels (``csrc/fused_mlp_bwd.cu``) at the four shapes of the
supervised step (B = 4) beside their bound, the plain VJP's device time (the
plain version recomputed and differentiated by autograd, f32 products) and
the five products in bf16 through ``torch.matmul`` (a yardstick only), the
masked-attention forward (``csrc/masked_attention.cu``: the key-split pass
and the merge, and on the entry point the mask preparation) and backward
(``csrc/masked_attention_bwd.cu``, on the shared mask the decoder gives it,
beside the device time of the SDPA backward's kernels on the same inputs)
at the decoder's three key counts, the window attention
(``csrc/window_attention.cu``) at its eight shapes (each stage unshifted and
shifted), the window attention + output projection
(``csrc/window_attention_proj.cu``: the attention launch and the projection
GEMM, each by its kernel name) at the same eight shapes with C = H x D, the
P-folded deformable sampling (``csrc/msda_folded.cu``) at the
encoder's shape and through its one-level wrapper at each level, its banded
variant at the encoder's shape beside the dense kernel on the same inputs
(the stage-3 CLI's radius 4 and 512-query tiles, offsets planted up to 12
level pixels so that the band acts), and the per-tap sampling
(``csrc/msda_taps.cu``) at each level.

Traces ``--calls`` calls of each with ``torch.profiler`` after a warm-up and
prints one JSON line per shape: the device ms per call of each kernel name
and their sum. With ``--tiles``, also the LN -> MLP GEMMs' device time at
each shape with every column tile the kernel has (both GEMMs on the same
tile), against which ``ops/fused_mlp.mlp_plan``'s choice is read, the
same for the projection GEMM of the window attention + projection, and the
LN -> MLP backward's device time with ``mlp_bwd_plan``'s choice changed one
GEMM at a time (column tiles; the weight gradients' split-K factors).
``--kernels`` picks the wrappers; ``--root`` imports the package from
another checkout (an unpacked older commit), so two trees are measured in
one run on one card. Run from the repository root on one GPU:
``python3 tools/torch_kernel_breakdown.py [--tiles] [--kernels ...] [--root DIR]``
(``--kernels`` from ln, mlp, mlp_bwd, masked, masked_bwd, window, window_proj,
msda, msda_banded, msda_taps).
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

MLP_SHAPES = [(51200, 192), (12800, 384), (3200, 768), (800, 1536)]
# the MLP's tokens and widths at B = 4: the supervised step, which takes its backward
MLP_BWD_SHAPES = [(102400, 192), (25600, 384), (6400, 768), (1600, 1536)]
# LayerNorm rows x C: patch norm and res2 norms; res2 merge and res3 norms;
# res3 merge and res4 norms; res4 merge and res5 norms; res5's output norm
LN_SHAPES = [(51200, 192), (12800, 384), (12800, 768), (3200, 768), (3200, 1536),
             (800, 1536), (800, 3072)]
MASKED_KEYS = [400, 1600, 6400]
# window attention (Bw, H, D, P) at res2..res5, unshifted (P = 1) then
# shifted (P = windows per image), N = 144 tokens per 12 x 12 window
WINDOW_SHAPES = [(392, 6, 32, 1), (392, 6, 32, 196), (98, 12, 32, 1), (98, 12, 32, 49),
                 (32, 24, 32, 1), (32, 24, 32, 16), (8, 48, 32, 1), (8, 48, 32, 4)]
MSDA_LEVELS = ((20, 20), (40, 40), (80, 80))  # res5, res4, res3 at 640^2
KERNELS = ("ln", "mlp", "mlp_bwd", "masked", "masked_bwd", "window", "window_proj", "msda",
           "msda_banded", "msda_taps")


def per_call_device_ms(fn, calls: int) -> dict:
    """{kernel name: device ms per call} over ``calls`` traced calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    sums = defaultdict(float)
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            sums[name[:100]] += ev.time_range.elapsed_us() / 1e3
    return {name: ms / calls for name, ms in sorted(sums.items(), key=lambda kv: -kv[1])}


def mlp_tile_sweep(fm, args, calls: int) -> dict:
    """{column tile: [fc1 ms, fc2 ms]} with ``mlp_plan`` pinned to each tile."""
    plan = fm.mlp_plan
    out = {}
    try:
        for bn in fm._COLUMN_TILES:
            fm.mlp_plan = lambda n, c, f, bn=bn: {"bn1": bn, "bn2": bn}
            ms = per_call_device_ms(lambda: fm.fused_ln_mlp(*args), calls)
            # the GEMM kernel's second template argument is its epilogue: 0 fc1, 1 fc2
            out[bn] = [sum(v for k, v in ms.items() if f"<{bn}, {e}>" in k) for e in (0, 1)]
    finally:
        fm.mlp_plan = plan
    return out


def mlp_bwd_plan_sweep(fm, args, g_out, calls: int) -> dict:
    """{plan change: ms of the backward by CUDA events} with ``mlp_bwd_plan``
    pinned to the chosen plan ("chosen"), to the other column tile of fc1, dH
    and dxn each, and to each column tile and split-K factor of dW2 and dW1.
    Events, not the profiler's per-kernel sums, which can miss launches."""
    from partdistillation_torch.utils.timing import time_ms

    plan = fm.mlp_bwd_plan
    n, c = args[0].shape
    base = dict(plan(n, c, 4 * c))
    ktiles = -(-n // 64)
    changes = {"chosen": {}}
    for key in ("bn_h", "bn_dh", "bn_dx"):
        changes[f"{key}={192 - base[key]}"] = {key: 192 - base[key]}
    for w in ("dw2", "dw1"):
        for bn in (64, 128):
            for splits in (1, 2, 3, 4, 6, 8, 11, 16, 22, 32):
                if splits <= ktiles:
                    changes[f"{w} bn={bn} splits={splits}"] = {f"bn_{w}": bn,
                                                              f"splits_{w}": splits}
    out = {}
    try:
        for name, change in changes.items():
            fm.mlp_bwd_plan = lambda *_, pinned={**base, **change}: pinned
            out[name] = time_ms(lambda: fm.fused_ln_mlp_backward(g_out, *args[:6]), calls)
    finally:
        fm.mlp_bwd_plan = plan
    return out


def proj_tile_sweep(fa, fm, args, calls: int) -> dict:
    """{column tile: ms} of the projection GEMM inside the window attention +
    projection, with its plan pinned to each tile."""
    tile = fa._column_tile
    out = {}
    try:
        for bn in fm._COLUMN_TILES:
            fa._column_tile = lambda m, n, bn=bn: bn
            fa.window_attention_proj_plan.cache_clear()
            ms = per_call_device_ms(lambda: fa.fused_window_attention_proj(*args), calls)
            # the GEMM's projection instance: second template argument 2
            out[bn] = sum(v for k, v in ms.items() if f"<{bn}, 2>" in k)
    finally:
        fa._column_tile = tile
        fa.window_attention_proj_plan.cache_clear()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", action="store_true",
                    help="time the MLP and projection GEMMs with every column tile too, "
                         "and the MLP's backward with other tiles and split-K factors")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS))
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose partdistillation_torch is measured")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    tree = str(Path(args.root).resolve())
    for n, c in LN_SHAPES if "ln" in args.kernels else ():
        x = randn(n, c)
        sc = torch.randn(c, generator=g, device="cuda")
        bi = torch.randn(c, generator=g, device="cuda")
        ms = per_call_device_ms(lambda: ln.fused_layer_norm(x, sc, bi), args.calls)
        plan = getattr(ln, "layer_norm_plan", None)
        print(json.dumps({"kernel": "fused_layer_norm", "tree": tree, "shape": [n, c],
                          "plan": plan(n, c, bf, True) if plan else None,
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)

    for n, c in MLP_SHAPES if "mlp" in args.kernels else ():
        f = 4 * c
        a = (randn(n, c), randn(c, scale=0.5) + 1.0, randn(c, scale=0.1),
             randn(f, c, scale=c ** -0.5), randn(f, scale=0.1),
             randn(c, f, scale=f ** -0.5), randn(c, scale=0.1))
        ms = per_call_device_ms(lambda: fm.fused_ln_mlp(*a), args.calls)
        print(json.dumps({"kernel": "fused_ln_mlp", "shape": [n, c],
                          "plan": fm.mlp_plan(n, c, f), "device_ms_per_call": ms,
                          "total_ms": sum(ms.values())}), flush=True)
        if args.tiles:
            print(json.dumps({"kernel": "fused_ln_mlp", "shape": [n, c],
                              "fc1_fc2_ms_by_column_tile": mlp_tile_sweep(fm, a, args.calls)}),
                  flush=True)

    for n, c in MLP_BWD_SHAPES if "mlp_bwd" in args.kernels else ():
        f = 4 * c
        a = (randn(n, c, scale=2.0), randn(c, scale=0.5) + 1.0, randn(c, scale=0.1),
             randn(f, c, scale=c ** -0.5), randn(f, scale=0.1),
             randn(c, f, scale=f ** -0.5), randn(c, scale=0.1))
        g_out = randn(n, c)
        ms = per_call_device_ms(lambda: fm.fused_ln_mlp_backward(g_out, *a[:6]), args.calls)
        leaves = [t.clone().requires_grad_() for t in a]
        plain = per_call_device_ms(lambda: torch.autograd.grad(
            fm.ln_mlp_kernel_numerics(*leaves), leaves, g_out), max(args.calls // 4, 2))
        # the yardstick: the five products in bf16 through cuBLAS
        xn, h, dpre = randn(n, c), randn(n, f), randn(n, f)
        w1, w2 = a[3], a[5]
        library = per_call_device_ms(lambda: (xn @ w1.t(), g_out @ w2, g_out.t() @ h,
                                              dpre.t() @ xn, dpre @ w1), args.calls)
        flops = 5 * 2 * n * c * f
        # x and g read, dx written; w1 and w2 read, their gradients written; the vectors
        nbytes = 3 * n * c * 2 + 4 * c * f * 2 + 8 * c * 2 + 2 * f * 2
        bound = max((nbytes / 3.35e12, "bytes"), (flops / 989e12, "operations"))
        print(json.dumps({"kernel": "fused_ln_mlp_backward", "tree": tree, "shape": [n, c],
                          "plan": fm.mlp_bwd_plan(n, c, f), "device_ms_per_call": ms,
                          "total_ms": sum(ms.values()), "bound_ms": bound[0] * 1e3,
                          "bound_by": bound[1], "plain_vjp_ms": sum(plain.values()),
                          "library_bf16_products_ms": sum(library.values())}), flush=True)
        if args.tiles:
            print(json.dumps({"kernel": "fused_ln_mlp_backward", "shape": [n, c],
                              "ms_by_plan": mlp_bwd_plan_sweep(fm, a, g_out, args.calls)}),
                  flush=True)

    for nk in MASKED_KEYS if "masked" in args.kernels else ():
        q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
        m = torch.rand((2, 1, 200, nk), generator=g, device="cuda") < 0.6
        prepared = fa._effective_mask(q, k, m)
        for what, fn in (("launches", lambda: fa._masked_fwd(q, k, v, prepared, None)),
                         ("wrapper", lambda: fa.fused_masked_attention(q, k, v, m))):
            ms = per_call_device_ms(fn, args.calls)
            print(json.dumps({"kernel": "fused_masked_attention", "call": what,
                              "shape": [2, 8, 200, nk, 32],
                              "plan": fa.masked_attention_plan(2, 8, 200, nk, 32),
                              "device_ms_per_call": ms, "total_ms": sum(ms.values())}),
                  flush=True)

    for nk in MASKED_KEYS if "masked_bwd" in args.kernels else ():
        q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
        g_out = randn(2, 8, 200, 32)
        m = torch.rand((2, 1, 200, nk), generator=g, device="cuda") < 0.6
        out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, m)
        ms = per_call_device_ms(
            lambda: fa.fused_masked_attention_bwd(q, k, v, mask, out, lse, g_out), args.calls)
        plan = getattr(fa, "masked_attention_bwd_plan", None)
        print(json.dumps({"kernel": "fused_masked_attention_bwd", "tree": tree,
                          "shape": [2, 8, 200, nk, 32],
                          "plan": plan(2, 8, 200, nk, 32) if plan else None,
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)
        # the yardstick: SDPA's backward on the same inputs and additive mask
        add = torch.where(m & ~m.all(-1, keepdim=True), -1e9, 0.0).to(bf)
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, attn_mask=add,
                                                                   scale=1.0)
        ms = per_call_device_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g_out,
                                                            retain_graph=True), args.calls)
        print(json.dumps({"kernel": "sdpa_backward", "tree": tree, "shape": [2, 8, 200, nk, 32],
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)

    for bw, h, d, p in WINDOW_SHAPES if "window" in args.kernels else ():
        qt, kt, vt = (randn(bw, h, d, 144) for _ in range(3))
        bias = torch.randn((p, h, 144, 144), generator=g, device="cuda")
        ms = per_call_device_ms(
            lambda: fa.fused_window_attention(qt, kt, vt, bias, d ** -0.5), args.calls)
        plan = getattr(fa, "window_attention_plan", None)
        print(json.dumps({"kernel": "fused_window_attention", "tree": tree,
                          "shape": [bw, h, d, 144, p],
                          "plan": plan(bw, h, p) if plan else None,
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)

    for bw, h, d, p in WINDOW_SHAPES if "window_proj" in args.kernels else ():
        c = h * d
        qt, kt, vt = (randn(bw, h, d, 144) for _ in range(3))
        bias = torch.randn((p, h, 144, 144), generator=g, device="cuda")
        w, b = randn(c, c, scale=c ** -0.5), randn(c, scale=0.1)
        ms = per_call_device_ms(
            lambda: fa.fused_window_attention_proj(qt, kt, vt, bias, w, b, d ** -0.5),
            args.calls)
        plan = getattr(fa, "window_attention_proj_plan", None)
        print(json.dumps({"kernel": "fused_window_attention_proj", "tree": tree,
                          "shape": [bw, h, d, 144, c, p],
                          "plan": plan(bw, h, d, 144, c, p) if plan else None,
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)
        if args.tiles and plan:
            print(json.dumps({"kernel": "fused_window_attention_proj",
                              "shape": [bw, h, d, 144, c, p],
                              "gemm_ms_by_column_tile": proj_tile_sweep(
                                  fa, fm, (qt, kt, vt, bias, w, b, d ** -0.5), args.calls)}),
                  flush=True)

    if {"msda", "msda_banded", "msda_taps"} & set(args.kernels):
        from partdistillation_torch.ops import msda_sampling as msd
        lane_plan = getattr(msd, "msda_lane_plan", None)
        plan = lane_plan(32) if lane_plan else None

    if "msda" in args.kernels:
        # the encoder's call (value (2, 8400, 8, 32); taps within four pixels of
        # each query's reference point, bf16 weights), as chip_smoke.py makes it
        from partdistillation_torch.models.pixel_decoder import _reference_points

        s_len = sum(h * w for h, w in MSDA_LEVELS)
        value = randn(2, s_len, 8, 32)
        ref = _reference_points(MSDA_LEVELS, "cuda")[None, :, None, :, None, :]
        size = torch.tensor([[w, h] for h, w in MSDA_LEVELS], dtype=torch.float32,
                            device="cuda")
        loc = ref + (torch.rand((2, s_len, 8, 3, 4, 2), generator=g, device="cuda") * 8.0
                     - 4.0) / size[None, None, None, :, None, :]
        attw = torch.softmax(torch.randn((2, s_len, 8, 12), generator=g, device="cuda"),
                             -1).reshape(2, s_len, 8, 3, 4).to(bf)
        ms = per_call_device_ms(lambda: msd.msda_folded(value, MSDA_LEVELS, loc, attw),
                                args.calls)
        print(json.dumps({"kernel": "msda_folded", "tree": tree, "shape": [2, s_len, 8, 32],
                          "levels": MSDA_LEVELS, "points": 4, "plan": plan,
                          "device_ms_per_call": ms, "total_ms": sum(ms.values())}), flush=True)
        for h, w in MSDA_LEVELS:
            v1 = randn(16, h * w, 32)
            x1 = torch.rand((16, 4, s_len), generator=g, device="cuda") * (w + 3.0) - 2.0
            y1 = torch.rand((16, 4, s_len), generator=g, device="cuda") * (h + 3.0) - 2.0
            a1 = torch.rand((16, 4, s_len), generator=g, device="cuda")
            ms = per_call_device_ms(lambda: msd.sample_level_folded(v1, x1, y1, a1, h, w),
                                    args.calls)
            print(json.dumps({"kernel": "sample_level_folded", "tree": tree,
                              "shape": [16, 4, s_len, 32], "level": [h, w], "plan": plan,
                              "device_ms_per_call": ms, "total_ms": sum(ms.values())}),
                  flush=True)

    if "msda_banded" in args.kernels:
        from partdistillation_torch.models.pixel_decoder import _reference_points
        from partdistillation_torch.ops import ms_deform_attn as msda

        s_len = sum(h * w for h, w in MSDA_LEVELS)
        value = randn(2, s_len, 8, 32)
        ref = _reference_points(MSDA_LEVELS, "cuda")[None, :, None, :, None, :]
        size = torch.tensor([[w, h] for h, w in MSDA_LEVELS], dtype=torch.float32,
                            device="cuda")
        loc = ref + (torch.rand((2, s_len, 8, 3, 4, 2), generator=g, device="cuda") * 24.0
                     - 12.0) / size[None, None, None, :, None, :]
        attw = torch.softmax(torch.randn((2, s_len, 8, 12), generator=g, device="cuda"),
                             -1).reshape(2, s_len, 8, 3, 4).to(bf)
        band = msda.msda_band_table(MSDA_LEVELS, 4, 512, None, "cuda")
        for name, kw in (("dense", {}), ("banded", {"band": band}), ("dense", {}),
                         ("banded", {"band": band})):
            ms = per_call_device_ms(lambda: msd.msda_folded(value, MSDA_LEVELS, loc, attw, **kw),
                                    args.calls)
            print(json.dumps({"kernel": f"msda_folded {name}", "tree": tree,
                              "shape": [2, s_len, 8, 32], "levels": MSDA_LEVELS, "points": 4,
                              "band_radius": 4, "band_tile_queries": 512,
                              "band_table_bytes": band.numel() * 4,
                              "oob_fraction": float(msda.msda_band_oob_fraction(
                                  MSDA_LEVELS, loc, attw, 4, 512)),
                              "device_ms_per_call": ms, "total_ms": sum(ms.values())}),
                  flush=True)

    for h, w in MSDA_LEVELS if "msda_taps" in args.kernels else ():
        n = 8400 * 4
        v = randn(16, w, h * 32)
        x = torch.rand((16, n), generator=g, device="cuda") * (w + 3.0) - 2.0
        y = torch.rand((16, n), generator=g, device="cuda") * (h + 3.0) - 2.0
        a = torch.rand((16, n), generator=g, device="cuda")
        ms = per_call_device_ms(lambda: msd.sample_level(v, x, y, a, h, w), args.calls)
        print(json.dumps({"kernel": "sample_level", "tree": tree, "shape": [16, n, 32],
                          "level": [h, w], "plan": plan, "device_ms_per_call": ms,
                          "total_ms": sum(ms.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
