#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``partdistillation_torch``) on one GPU.

Phases, each printing one JSON line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build: the hand-written kernels from ``partdistillation_torch/csrc``;
  3. per-kernel checks at every input shape the main path gives each kernel
     (B=2, bf16, 640^2): the kernel against its plain PyTorch version
     (max_abs_err within a stated tolerance), then kernel / plain /
     library-call times and the card's bound at the kernel's most frequent
     main-path shape;
  4. main path: ``make_inference_fn`` on the full-width Swin-L + MSDeformAttn
     pixel decoder + 9-layer masked decoder (seeded random weights) over
     three batches of synthetic images with GT and object masks,
     through ``ProposalEvaluator``; per-batch latency, images/s, peak memory
     and each kernel's launch count (must equal launches per forward x
     forwards);
  5. the same forward with every kernel swapped for its plain version on the
     card, same weights: pred_logits / pred_masks compared;
  6. a ``kernels`` line with every kernel's numbers;
  7. the last line: {"ok": true, "device": {...}}.

Exits non-zero, with no result line, when no CUDA device is present, when a
kernel fails to build or launch, or when any check fails. Run from the
repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores
BATCHES, BATCH_SIZE, IMAGE_SIZE = 3, 2, 640  # the main path: 3 batches of B=2 at 640^2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least ms, "bytes" | "operations") for the work at the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 3


def main_path_shapes():
    """Every distinct input shape the main path (Swin-L, 640^2, B=2) gives
    each kernel, from the model's configuration."""
    from partdistillation_torch.models.swin import swin_large_config

    sw, b = swin_large_config(), BATCH_SIZE
    ws = sw.window_size
    ln, mlp, win = set(), [], []
    for s in range(sw.num_layers):
        side, c, h = IMAGE_SIZE // sw.patch_size // 2 ** s, sw.stage_dim(s), sw.num_heads[s]
        ln.add((b * side * side, c))  # patch norm, norm1, output norm
        if s < sw.num_layers - 1:
            ln.add((b * (side // 2) ** 2, 4 * c))  # patch-merging norm
        mlp.append((b * side * side, c))
        n_win = (-(-side // ws)) ** 2
        for groups in ((1, n_win) if side > ws else (1,)):  # unshifted, shifted
            win.append((b * n_win, h, c // h, groups))
    # the decoder's keys: the pixel decoder's levels at strides 32 / 16 / 8
    masked = [(IMAGE_SIZE // stride) ** 2 for stride in (32, 16, 8)]
    return sorted(ln), mlp, win, masked


def kernel_checks(seed: int):
    """Each kernel vs its plain version at every main-path shape (B=2, 640^2),
    timed at its most frequent one."""
    import torch
    import torch.nn.functional as F

    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bf = torch.bfloat16
    ln_shapes, mlp_shapes, win_shapes, masked_keys = main_path_shapes()

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def compare(name, kern, plain, tol_rel):
        out_k, out_p = kern(), plain()
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        scale = out_p.float().abs().max().item()
        if not np.isfinite(err) or err > tol_rel * scale:
            fail(f"{name}: max_abs_err {err} > {tol_rel} x max|plain| {scale}")
        return err, err / scale

    def worst(errs, tol_rel):
        # max |kernel - plain| over the shapes, and the largest ratio of that
        # error to max |plain|, which the check holds to tol_rel
        return dict(err=max(e for e, _ in errs), rel_err=max(r for _, r in errs),
                    tol_rel=tol_rel)

    results = {}

    # 1. LayerNorm (bf16 on the main path; f32 checked too); timed at the
    #    patch-norm / res2 rows (B*160*160 x 192)
    tol = 2.0 ** -7  # one bf16 rounding of the output (relative to max |y|)
    errs = []
    for shape, dtype in [(s, bf) for s in ln_shapes] + [(ln_shapes[-1], torch.float32)]:
        x = randn(*shape, dtype=dtype)
        sc, bi = randn(shape[1], dtype=torch.float32), randn(shape[1], dtype=torch.float32)
        e = compare("layer_norm", lambda: ln.fused_layer_norm(x, sc, bi),
                    lambda: ln.layer_norm_plain(x, sc, bi), tol if dtype == bf else 1e-5)
        if dtype == bf:
            errs.append(e)
    rows, c = 2 * 160 * 160, 192
    x = randn(rows, c)
    sc, bi = randn(c, dtype=torch.float32), randn(c, dtype=torch.float32)
    w_bf, b_bf = sc.to(bf), bi.to(bf)
    results["layer_norm"] = dict(
        **worst(errs, tol), shapes_checked=len(ln_shapes) + 1, shape=[rows, c],
        ms=time_ms(lambda: ln.fused_layer_norm(x, sc, bi)),
        plain_ms=time_ms(lambda: ln.layer_norm_plain(x, sc, bi)),
        library_ms=time_ms(lambda: F.layer_norm(x, (c,), w_bf, b_bf)),
        bound=bound(2 * rows * c * 2 + 2 * c * 4, 8 * rows * c, PEAK_F32_FLOPS))

    # 2. fused LN->MLP at each stage, both add_residual values; timed at res4
    #    (B*40*40 tokens, C=768: 18 of the 24 launches)
    def mlp_inputs(t, c):
        f = 4 * c
        return (randn(t, c), randn(c, scale=0.5) + 1.0, randn(c, scale=0.1),
                randn(f, c, scale=c ** -0.5), randn(f, scale=0.1),
                randn(c, f, scale=f ** -0.5), randn(c, scale=0.1))

    tol = 2.0 ** -6  # bf16 hidden and output roundings (relative to max |y|)
    errs = []
    for t, c in mlp_shapes:
        a = mlp_inputs(t, c)
        for res in (True, False):
            errs.append(compare("fused_ln_mlp", lambda: fm.fused_ln_mlp(*a, add_residual=res),
                                lambda: fm.ln_mlp_kernel_numerics(*a, add_residual=res), tol))
    t, c = 2 * 40 * 40, 768
    a = mlp_inputs(t, c)
    x, g1, be, w1, b1, w2, b2 = a

    def mlp_library():
        h = F.gelu(F.linear(F.layer_norm(x, (c,), g1, be), w1, b1))
        return x + F.linear(h, w2, b2)

    results["fused_ln_mlp"] = dict(
        **worst(errs, tol), shapes_checked=2 * len(mlp_shapes), shape=[t, c],
        ms=time_ms(lambda: fm.fused_ln_mlp(*a)),
        plain_ms=time_ms(lambda: fm.ln_mlp_kernel_numerics(*a)),
        library_ms=time_ms(mlp_library),
        bound=bound(2 * t * c * 2 + 2 * 4 * c * c * 2 + (6 * c) * 2, 16 * t * c * c))

    # 3. window attention at each stage, unshifted (P=1) and shifted (P=nW);
    #    timed at the res2 shifted block (Bw = B*196, H=6, D=32, N=144, P=196)
    def win_inputs(bw, h, d, p):
        qt, kt, vt = (randn(bw, h, d, 144) for _ in range(3))
        return qt, kt, vt, randn(p, h, 144, 144, dtype=torch.float32)

    tol = 2.0 ** -6  # bf16 probabilities and output rounding (relative to max |o|)
    errs = []
    for bw, h, d, p in win_shapes:
        qt, kt, vt, bias = win_inputs(bw, h, d, p)
        errs.append(compare(
            "fused_window_attention",
            lambda: fa.fused_window_attention(qt, kt, vt, bias, d ** -0.5),
            lambda: fa.window_attention_plain(qt, kt, vt, bias, d ** -0.5), tol))
    bw, h, p = 2 * 196, 6, 196
    scale = 32 ** -0.5
    qt, kt, vt, bias = win_inputs(bw, h, 32, p)
    full_bias = bias.repeat_interleave(bw // p, dim=0).to(bf)
    qn, kn, vn = (t_.transpose(-1, -2) for t_ in (qt, kt, vt))
    results["fused_window_attention"] = dict(
        **worst(errs, tol), shapes_checked=len(win_shapes), shape=[bw, h, 32, 144],
        ms=time_ms(lambda: fa.fused_window_attention(qt, kt, vt, bias, scale)),
        plain_ms=time_ms(lambda: fa.window_attention_plain(qt, kt, vt, bias, scale)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qn, kn, vn, attn_mask=full_bias, scale=scale)),
        bound=bound(4 * bw * h * 32 * 144 * 2 + p * h * 144 * 144 * 4,
                    4 * bw * h * 144 * 144 * 32))

    # 4. masked cross-attention: (2, 8, 200, 32) against each key count, the
    #    mask shared across heads as on the main path (and once per head);
    #    timed at K = 6400
    tol = 2.0 ** -6  # bf16 exp(s - max) before P.V (relative to max |o|)
    errs = []
    for nk, mh in [(nk, 1) for nk in masked_keys] + [(masked_keys[0], 8)]:
        q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
        m = torch.rand((2, mh, 200, nk), generator=g, device=dev) < 0.6
        m[:, :, :5] = True  # all-blocked rows take the fix-up
        errs.append(compare("fused_masked_attention",
                            lambda: fa.fused_masked_attention(q, k, v, m),
                            lambda: fa.masked_attention_plain(q, k, v, m), tol))
    nk = masked_keys[-1]
    q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
    m = torch.rand((2, 1, 200, nk), generator=g, device=dev) < 0.6
    add = torch.where(m & ~m.all(-1, keepdim=True), -1e9, 0.0).to(bf)
    results["fused_masked_attention"] = dict(
        **worst(errs, tol), shapes_checked=len(masked_keys) + 1, shape=[2, 8, 200, nk, 32],
        ms=time_ms(lambda: fa.fused_masked_attention(q, k, v, m)),
        plain_ms=time_ms(lambda: fa.masked_attention_plain(q, k, v, m)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=add, scale=1.0)),
        bound=bound((2 * 8 * 200 * 32 * 2) * 2 + 2 * (2 * 8 * nk * 32 * 2) + 2 * 200 * nk,
                    4 * 2 * 8 * 200 * nk * 32))
    return results


# --------------------------------------------------------------- phase 4/5


def synthetic_batch(rng: np.random.Generator, b: int, size: int, parts: int = 8):
    """uint8 images; one rectangular object per image split into a grid of
    part masks (the GT the proposals are matched against)."""
    images = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    part_masks = np.zeros((b, parts, size, size), bool)
    object_masks = np.zeros((b, 1, size, size), bool)
    for i in range(b):
        y0, x0 = rng.integers(0, size // 4, 2)
        y1, x1 = rng.integers(3 * size // 4, size, 2)
        object_masks[i, 0, y0:y1, x0:x1] = True
        ys = np.linspace(y0, y1, 3).astype(int)
        xs = np.linspace(x0, x1, parts // 2 + 1).astype(int)
        k = 0
        for r in range(2):
            for cc in range(parts // 2):
                part_masks[i, k, ys[r]:ys[r + 1], xs[cc]:xs[cc + 1]] = True
                k += 1
    return {"image": images, "part_masks": part_masks,
            "part_labels": np.zeros((b, parts), np.int32),
            "part_valid": np.ones((b, parts), bool),
            "object_masks": object_masks, "object_valid": np.ones((b, 1), bool)}


def full_config():
    import torch

    from partdistillation_torch.models.meta_arch.proposal import ProposalModelConfig
    from partdistillation_torch.models.pixel_decoder import PixelDecoderConfig
    from partdistillation_torch.models.segmenter import SegmenterConfig
    from partdistillation_torch.models.swin import swin_large_config
    from partdistillation_torch.models.transformer_decoder import TransformerDecoderConfig

    bf = torch.bfloat16
    seg = SegmenterConfig(swin=swin_large_config(dtype=bf),
                          pixel_decoder=PixelDecoderConfig(dtype=bf),
                          decoder=TransformerDecoderConfig(num_classes=1, num_queries=200,
                                                           dec_layers=9, dtype=bf))
    return ProposalModelConfig(segmenter=seg, test_topk=200)


PER_FORWARD = {"layer_norm": 32, "fused_ln_mlp": 24, "fused_window_attention": 24,
               "fused_masked_attention": 9}


def wrappers():
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln

    return {"layer_norm": ln.fused_layer_norm, "fused_ln_mlp": fm.fused_ln_mlp,
            "fused_window_attention": fa.fused_window_attention,
            "fused_masked_attention": fa.fused_masked_attention}


@contextlib.contextmanager
def plain_versions():
    """Swap every kernel wrapper the models call for its plain version."""
    from partdistillation_torch.models import attention, swin
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln

    swaps = [(swin, "fused_layer_norm", ln.layer_norm_plain),
             (swin, "fused_ln_mlp", fm.ln_mlp_kernel_numerics),
             (swin, "fused_window_attention", fa.window_attention_plain),
             (attention, "fused_masked_attention", fa.masked_attention_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main_path(seed: int):
    import torch

    from partdistillation_torch.evaluation.proposal_evaluator import ProposalEvaluator
    from partdistillation_torch.models.meta_arch.proposal import (
        make_inference_fn, normalize_images)
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = full_config()
    t0 = time.perf_counter()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    infer = make_inference_fn(cfg, model, device="cuda")
    rng = np.random.default_rng(seed)
    batches = [synthetic_batch(rng, BATCH_SIZE, IMAGE_SIZE) for _ in range(BATCHES)]
    evaluator = ProposalEvaluator(limits=(1, 10, 50, 100, 200))

    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = infer(batch)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        host = {k: out[k].cpu().numpy() for k in ("pred_masks", "valid")}
        host["scores"] = out["scores"].float().cpu().numpy()
        evaluator.process(host, batch["part_masks"], batch["part_valid"])
        k = cfg.test_topk
        b, size = BATCH_SIZE, IMAGE_SIZE
        if host["pred_masks"].shape != (b, k, size, size) or host["pred_masks"].dtype != bool:
            fail(f"pred_masks shape/dtype {host['pred_masks'].shape} {host['pred_masks'].dtype}")
        if not np.isfinite(host["scores"]).all() or host["scores"].min() < 0 \
                or host["scores"].max() > 1:
            fail("scores not finite probabilities")
    launches = {name: fn.launches for name, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    ar = evaluator.evaluate()
    if not all(np.isfinite(v) for v in ar.values()):
        fail(f"non-finite AR {ar}")
    for name, per in PER_FORWARD.items():
        if launches[name] != per * BATCHES:
            fail(f"{name}: {launches[name]} launches, expected {per} x {BATCHES}")
    steady = latencies[1:] or latencies
    emit({"phase": "main_path", "config": "Swin-L/MSDeformAttn/9-layer decoder, bf16",
          "image_size": IMAGE_SIZE, "batch_size": BATCH_SIZE,
          "batches": BATCHES, "params": n_params,
          "model_build_s": round(build_s, 3),
          "batch_latency_s": [round(x, 5) for x in latencies],
          "median_steady_latency_s": round(statistics.median(steady), 5),
          "images_per_s_steady": round(BATCH_SIZE * len(steady) / sum(steady), 3),
          "max_memory_allocated_bytes": int(peak), "launches": launches,
          "launches_per_forward": PER_FORWARD, "ar": ar})

    # phase 5: the same forward through the plain versions, same weights
    images = normalize_images(torch.as_tensor(batches[0]["image"], device="cuda"))
    with torch.inference_mode():
        out_k = model(images)
        with plain_versions():
            out_p = model(images)
    for name, fn in fns.items():
        if fn.launches != launches[name] + PER_FORWARD[name]:
            fail(f"{name}: the plain-version forward launched the kernel")
    cmp = {}
    for key in ("pred_logits", "pred_masks"):
        a, p = out_k[key].float(), out_p[key].float()
        if not torch.isfinite(a).all() or not torch.isfinite(p).all():
            fail(f"non-finite {key}")
        cmp[key] = {"max_abs_err": (a - p).abs().max().item(),
                    "mean_abs_err": (a - p).abs().mean().item(),
                    "mean_abs_plain": p.abs().mean().item(),
                    "sign_agreement": (torch.sign(a) == torch.sign(p)).float().mean().item()}
    # stated tolerance: 24 bf16 Swin blocks + 6 encoder + 9 decoder layers of
    # bf16 rounding, with thresholded attention masks that may flip near 0.5
    ok = (cmp["pred_masks"]["mean_abs_err"] <= 0.05 * cmp["pred_masks"]["mean_abs_plain"]
          and cmp["pred_masks"]["sign_agreement"] >= 0.98
          and cmp["pred_logits"]["mean_abs_err"] <= 0.05 * cmp["pred_logits"]["mean_abs_plain"])
    emit({"phase": "kernels_vs_plain_forward", "tolerance": "mean |err| <= 5% of mean |plain| "
          "for pred_logits and pred_masks; mask-logit sign agreement >= 98%", **cmp, "ok": ok})
    if not ok:
        fail("kernel forward disagrees with the plain-version forward")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the synthetic batches and the kernel inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from partdistillation_torch.utils import native_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "environment", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    native_lib.load_library(verbose=True)  # prints nvcc's -Xptxas -v report
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(native_lib.build_library().name)})

    checks = kernel_checks(args.seed)
    emit({"phase": "kernel_checks", **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                                       for k, v in checks.items()}})
    launches = main_path(args.seed)

    meta = {
        "layer_norm": ("partdistillation_torch/csrc/layer_norm.cu",
                       "partdistillation_tpu/ops/layer_norm.py:37"),
        "fused_ln_mlp": ("partdistillation_torch/csrc/fused_mlp.cu",
                         "partdistillation_tpu/ops/fused_mlp.py:87"),
        "fused_window_attention": ("partdistillation_torch/csrc/window_attention.cu",
                                   "partdistillation_tpu/ops/fused_attention.py:257"),
        "fused_masked_attention": ("partdistillation_torch/csrc/masked_attention.cu",
                                   "partdistillation_tpu/ops/fused_attention.py:71"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        c = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                        "library_ms": c["library_ms"], "shape": c["shape"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
