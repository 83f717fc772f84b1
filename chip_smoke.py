#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``partdistillation_torch``) on one GPU.

Phases, each printing one JSON line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build: the hand-written kernels from ``partdistillation_torch/csrc``;
  3. per-kernel checks at every input shape the main paths give each kernel
     (B=2, bf16, 640^2): the kernel against its plain PyTorch version
     (max_abs_err within a stated tolerance), then kernel / plain /
     library-call times and the card's bound at the kernel's most frequent
     main-path shape;
  4. inference path: ``make_inference_fn`` on the full-width Swin-L +
     MSDeformAttn pixel decoder + 9-layer masked decoder (seeded random
     weights) over three batches of synthetic images with GT and object
     masks, through ``ProposalEvaluator``; per-batch latency, images/s, peak
     memory and each kernel's launch count (must equal launches per forward x
     forwards);
  5. the same forward with every kernel swapped for its plain version on the
     card, same weights: pred_logits / pred_masks compared;
  6. train path: ``Trainer.train_step`` over ``make_loss_fn`` on the same
     full-width model with the stage-3 CLI's settings (trunk frozen, DropPath
     0.3, 12544 grid points), four steps on synthetic batches of 8 pseudo
     masks with 2 padded slots per image; per-step latency, images/s, peak
     memory, the losses (finite), exact launch counts per step, the trunk
     bitwise unchanged and the decoder updated; then one step split into
     forward / criterion + matching / backward / optimizer with CUDA events;
  7. the same loss and gradients with every kernel swapped for its plain
     version, same weights, batch, noise and matching: total_loss and the
     decoder's gradients per parameter group compared (the cross-attention
     by q / k / v / out / norm), and the same comparison with dK planted to
     zero in the backward, which must fail; and each group's distance to the
     same step in f32 through the plain versions held to the plain bf16
     path's;
  8. a ``kernels`` line with every kernel's numbers;
  9. the last line: {"ok": true, "device": {...}}.

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
TRAIN_STEPS, MASK_SLOTS, PADDED_SLOTS = 4, 8, 2  # the train path: 4 steps, T = 8 (2 padded)
FREEZE_KEYS = ("backbone", "pixel_decoder")
TRUNK = ("backbone.", "sem_seg_head.pixel_decoder.")


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

    # 5. masked cross-attention backward: the same shapes, mask shared across
    #    heads and once per head at every key count; timed at K = 6400 with
    #    the shared mask (the main path's)
    tol = 2.0 ** -6  # bf16 P, dS and gradient roundings (relative to max |plain|)
    errs = []
    for nk in masked_keys:
        for mh in (1, 8):
            q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
            g_out = randn(2, 8, 200, 32)
            m = torch.rand((2, mh, 200, nk), generator=g, device=dev) < 0.6
            m[:, :, :5] = True
            out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, m)
            got = fa.fused_masked_attention_bwd(q, k, v, mask, out, lse, g_out)
            want = fa.masked_attention_bwd_plain(q, k, v, m, g_out)
            for which, a, b in zip(("dq", "dk", "dv"), got, want):
                errs.append(compare(f"fused_masked_attention_bwd {which} K={nk} mask_heads={mh}",
                                    lambda a=a: a, lambda b=b: b, tol))
    nk = masked_keys[-1]
    q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
    g_out = randn(2, 8, 200, 32)
    m = torch.rand((2, 1, 200, nk), generator=g, device=dev) < 0.6
    out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, m)
    add = torch.where(m & ~m.all(-1, keepdim=True), -1e9, 0.0).to(bf)
    ql, kl, vl = (t_.clone().requires_grad_() for t_ in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=add, scale=1.0)
    bhq, bhk = 2 * 8 * 200, 2 * 8 * nk
    results["fused_masked_attention_bwd"] = dict(
        **worst(errs, tol), shapes_checked=2 * len(masked_keys), shape=[2, 8, 200, nk, 32],
        ms=time_ms(lambda: fa.fused_masked_attention_bwd(q, k, v, mask, out, lse, g_out)),
        plain_ms=time_ms(lambda: fa.masked_attention_bwd_plain(q, k, v, m, g_out)),
        library_ms=time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g_out,
                                                       retain_graph=True)),
        # read q, g, o, k, v (bf16), lse (f32), the uint8 mask; write dq, dk, dv
        bound=bound(3 * bhq * 32 * 2 + 2 * bhk * 32 * 2 + bhq * 4 + 2 * 200 * nk
                    + bhq * 32 * 2 + 2 * bhk * 32 * 2, 10 * 2 * 8 * 200 * nk * 32))
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


def synthetic_train_batch(rng: np.random.Generator, b: int, size: int):
    """The train step's batch: uint8 images and MASK_SLOTS pseudo masks per
    image, the last PADDED_SLOTS of them padding (empty, invalid)."""
    src = synthetic_batch(rng, b, size, parts=MASK_SLOTS - PADDED_SLOTS)
    masks = np.zeros((b, MASK_SLOTS, size, size), bool)
    masks[:, :MASK_SLOTS - PADDED_SLOTS] = src["part_masks"]
    valid = np.zeros((b, MASK_SLOTS), bool)
    valid[:, :MASK_SLOTS - PADDED_SLOTS] = True
    return {"image": src["image"], "masks": masks, "valid": valid}


def train_config():
    """The stage-3 CLI's train configuration at full width: trunk frozen,
    DropPath 0.3, grid point mode with 12544 points."""
    import dataclasses

    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig

    cfg = full_config()
    seg = dataclasses.replace(cfg.segmenter, freeze_backbone=True, freeze_pixel_decoder=True)
    return dataclasses.replace(cfg, segmenter=seg, criterion=CriterionConfig(
        num_classes=1, num_points=12544,
        matcher=MatcherConfig(num_points=12544)))


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
               "fused_masked_attention": 9, "fused_masked_attention_bwd": 0}
# per train step: the same forward (23 of the 24 MLP launches in the branch
# form of the DropPath blocks) and one backward launch per decoder layer
PER_TRAIN_STEP = {**PER_FORWARD, "fused_masked_attention_bwd": 9}


def wrappers():
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln

    return {"layer_norm": ln.fused_layer_norm, "fused_ln_mlp": fm.fused_ln_mlp,
            "fused_window_attention": fa.fused_window_attention,
            "fused_masked_attention": fa.fused_masked_attention,
            "fused_masked_attention_bwd": fa.fused_masked_attention_bwd}


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


# --------------------------------------------------------------- phase 6/7


def _decoder_parts(name: str, grad):
    """(group, gradient) pieces of a decoder parameter's gradient. The
    cross-attention (the backward kernel's layer) is split by role, its packed
    in_proj into the q / k / v projections, so that a fault in one of dQ, dK
    and dV shows in a group of its own."""
    if "transformer_cross_attention_layers" in name:
        if "in_proj" in name:
            return list(zip(("cross_attention_q", "cross_attention_k", "cross_attention_v"),
                            grad.chunk(3, dim=0)))
        return [("cross_attention_out" if "out_proj" in name else "cross_attention_norm", grad)]
    for group, keys in (("self_attention", ("transformer_self_attention_layers",)),
                        ("ffn", ("transformer_ffn_layers",)),
                        ("prediction_heads", ("decoder_norm", "class_embed", "mask_embed"))):
        if any(k in name for k in keys):
            return [(group, grad)]
    return [("queries_and_inputs", grad)]  # query_feat / query_embed / level_embed / input_proj


def compare_grads(got, want):
    """Per decoder group: relative error and cosine of got against want."""
    import torch

    pieces = {}
    for name in want:
        for (group, a), (_, b) in zip(_decoder_parts(name, got[name]),
                                      _decoder_parts(name, want[name])):
            pieces.setdefault(group, ([], []))
            pieces[group][0].append(a.flatten())
            pieces[group][1].append(b.flatten())
    out = {}
    for group, (a, b) in sorted(pieces.items()):
        a, b = torch.cat(a).float(), torch.cat(b).float()
        out[group] = {"rel_err": ((a - b).norm() / b.norm()).item(),
                      "cosine": (a @ b / (a.norm() * b.norm()).clamp(min=1e-30)).item()}
    return out


# Limits of the kernel-vs-plain train step, per decoder group: about twice
# the largest reading of the sound runs on the card (PERF.md). The q and k
# projections of the cross-attention get their gradient through dS = P (dP -
# D) alone, a difference of near-equal terms that bf16 rounds differently in
# the kernel (f32 dP, D from the bf16 output) and in the plain version's
# autograd (dP rounded to bf16 at the probabilities' cast): they have limits
# of their own.
SCORE_GROUPS = ("cross_attention_q", "cross_attention_k")
SCORE_REL_ERR_LIMIT, SCORE_COSINE_LIMIT = 0.36, 0.967
GRAD_REL_ERR_LIMIT, GRAD_COSINE_LIMIT = 0.125, 0.996
LOSS_REL_ERR_LIMIT = 0.02
# Against the same step in f32 through the plain versions, each group of the
# kernel path may be at most this many times as far off as the plain bf16
# path (the sound run read 0.89-0.94: the kernel path is the closer one).
F32_DISTANCE_RATIO_LIMIT = 1.5


def within_limits(cmp) -> bool:
    def ok(group, v):
        rel, cos = ((SCORE_REL_ERR_LIMIT, SCORE_COSINE_LIMIT) if group in SCORE_GROUPS
                    else (GRAD_REL_ERR_LIMIT, GRAD_COSINE_LIMIT))
        return v["rel_err"] <= rel and v["cosine"] >= cos
    return all(ok(group, v) for group, v in cmp.items())


def f32_distance_ratios(got_vs_f32, plain_vs_f32):
    return {group: got_vs_f32[group]["rel_err"] / max(plain_vs_f32[group]["rel_err"], 1e-12)
            for group in plain_vs_f32}


def f32_config(cfg):
    """``cfg`` with every module computing in f32."""
    import dataclasses

    import torch

    seg = cfg.segmenter
    seg = dataclasses.replace(
        seg, swin=dataclasses.replace(seg.swin, dtype=torch.float32),
        pixel_decoder=dataclasses.replace(seg.pixel_decoder, dtype=torch.float32),
        decoder=dataclasses.replace(seg.decoder, dtype=torch.float32))
    return dataclasses.replace(cfg, segmenter=seg)


def train_path(seed: int):
    import torch

    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = train_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model, OptimizerConfig(freeze_keys=FREEZE_KEYS),
                      device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 1)
    batches = [synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE) for _ in range(TRAIN_STEPS)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    latencies, steps = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        steps.append(metrics)
    launches = {name: fn.launches for name, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"train step {i}: non-finite metrics {m}")
    for name, per in PER_TRAIN_STEP.items():
        if launches[name] != per * TRAIN_STEPS:
            fail(f"{name}: {launches[name]} launches in the train path, expected "
                 f"{per} x {TRAIN_STEPS}")
    trunk_changed = [n for n, p in model.named_parameters()
                     if n.startswith(TRUNK) and not torch.equal(p.detach(), before[n])]
    head = [n for n in before if not n.startswith(TRUNK)]
    head_changed = [n for n in head if not torch.equal(model.get_parameter(n).detach(),
                                                       before[n])]
    if trunk_changed:
        fail(f"frozen trunk parameters changed: {trunk_changed[:5]}")
    if len(head_changed) != len(head):
        fail(f"decoder parameters left unchanged: {sorted(set(head) - set(head_changed))[:5]}")
    steady = latencies[1:]
    emit({"phase": "train_path", "config": "Swin-L/MSDeformAttn/9-layer decoder, bf16, "
          "trunk frozen, drop_path 0.3, 12544 grid points", "image_size": IMAGE_SIZE,
          "batch_size": BATCH_SIZE, "mask_slots": MASK_SLOTS, "padded_slots": PADDED_SLOTS,
          "steps": TRAIN_STEPS, "step_latency_s": [round(x, 5) for x in latencies],
          "images_per_s_steps_2_to_4": round(BATCH_SIZE * len(steady) / sum(steady), 3),
          "max_memory_allocated_bytes": int(peak), "launches": launches,
          "launches_per_step": PER_TRAIN_STEP,
          "total_loss_per_step": [m["total_loss"] for m in steps],
          "grad_norm_per_step": [m["grad_norm"] for m in steps],
          "last_step_losses": steps[-1], "trunk_params_changed": 0,
          "decoder_params_changed": f"{len(head_changed)}/{len(head)}"})

    # one more step through the same calls as train_step, split by CUDA events
    batch = batches[0]
    t = loss_fn.device_batch(batch)
    noise = loss_fn.draw_noise(batch, trainer.generator)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    ev[0].record()
    outputs = loss_fn.forward(t, noise)
    ev[1].record()
    total, _ = loss_fn.criterion(outputs, t, noise)
    ev[2].record()
    total.backward()
    ev[3].record()
    trainer.apply_gradients()
    ev[4].record()
    torch.cuda.synchronize()
    split = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(
        ("forward", "criterion_and_matching", "backward", "optimizer"))}
    emit({"phase": "train_step_split_ms", **split, "total": ev[0].elapsed_time(ev[4])})
    del outputs, total

    # phase 7: kernel path against plain versions, same weights, batch, noise
    # and matching indices (computed once, so an LSAP flip near a tie in bf16
    # cannot decide the comparison)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)

    def loss_and_grads(lf=loss_fn, m=model):
        m.zero_grad(set_to_none=True)
        total, _ = lf(batch, noise)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: m.get_parameter(n).grad.detach().clone() for n in head}

    loss_k, grads_k = loss_and_grads()
    counts = {name: fn.launches for name, fn in fns.items()}
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    # the same step in f32 through the plain versions: how far bf16 alone
    # moves each group, in the kernel path and in the plain one
    cfg32 = f32_config(cfg)
    model32 = MaskFormerSegmenter(cfg32.segmenter, device="cuda", seed=seed).train()
    model32.load_state_dict(model.state_dict())
    with plain_versions():
        loss_32, grads_32 = loss_and_grads(make_loss_fn(cfg32, model32, device="cuda"), model32)
    del model32
    if {name: fn.launches for name, fn in fns.items()} != counts:
        fail("the plain-version train step launched a kernel")
    cmp = compare_grads(grads_k, grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    # the check's own control: the kernel path with a planted fault, dK
    # replaced by zeros in the backward, must fall outside the limits
    from partdistillation_torch.ops import fused_attention as fa

    real_bwd = fa.fused_masked_attention_bwd

    def bwd_without_dk(*args):
        dq, dk, dv = real_bwd(*args)
        return dq, torch.zeros_like(dk), dv

    bwd_without_dk.launches = 0  # the wrapper counts its launches by its module name
    fa.fused_masked_attention_bwd = bwd_without_dk
    try:
        _, grads_f = loss_and_grads()
    finally:
        fa.fused_masked_attention_bwd = real_bwd
    planted = compare_grads(grads_f, grads_p)
    plain_32 = compare_grads(grads_p, grads_32)
    ratios = f32_distance_ratios(compare_grads(grads_k, grads_32), plain_32)
    planted_ratios = f32_distance_ratios(compare_grads(grads_f, grads_32), plain_32)
    ok = (loss_rel <= LOSS_REL_ERR_LIMIT and within_limits(cmp)
          and max(ratios.values()) <= F32_DISTANCE_RATIO_LIMIT)
    planted_rejected = (not within_limits(planted)
                        and max(planted_ratios.values()) > F32_DISTANCE_RATIO_LIMIT)
    emit({"phase": "kernels_vs_plain_train_step",
          "tolerance": f"total_loss within {LOSS_REL_ERR_LIMIT}; per decoder group (the "
                       f"cross-attention split into q / k / v / out / norm) gradient "
                       f"|g_kernel - g_plain| / |g_plain| <= {GRAD_REL_ERR_LIMIT} and cosine "
                       f">= {GRAD_COSINE_LIMIT}, for {', '.join(SCORE_GROUPS)} "
                       f"<= {SCORE_REL_ERR_LIMIT} and >= {SCORE_COSINE_LIMIT}; per group "
                       f"|g_kernel - g_f32| <= {F32_DISTANCE_RATIO_LIMIT} x |g_plain - g_f32|",
          "total_loss_kernel": loss_k, "total_loss_plain": loss_p, "total_loss_f32": loss_32,
          "total_loss_rel_err": loss_rel, "groups": cmp,
          "plain_vs_f32": plain_32, "f32_distance_ratio": ratios,
          "planted_dk_zero": planted, "planted_dk_zero_f32_distance_ratio": planted_ratios,
          "planted_fault_rejected": planted_rejected, "ok": ok})
    if not ok:
        fail("kernel train step disagrees with the plain-version train step")
    if not planted_rejected:
        fail("the train-step check passed a backward with dK set to zero")
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
    infer_launches = main_path(args.seed)
    torch.cuda.empty_cache()
    launches = train_path(args.seed)

    meta = {
        "layer_norm": ("partdistillation_torch/csrc/layer_norm.cu",
                       "partdistillation_tpu/ops/layer_norm.py:37"),
        "fused_ln_mlp": ("partdistillation_torch/csrc/fused_mlp.cu",
                         "partdistillation_tpu/ops/fused_mlp.py:87"),
        "fused_window_attention": ("partdistillation_torch/csrc/window_attention.cu",
                                   "partdistillation_tpu/ops/fused_attention.py:257"),
        "fused_masked_attention": ("partdistillation_torch/csrc/masked_attention.cu",
                                   "partdistillation_tpu/ops/fused_attention.py:71"),
        "fused_masked_attention_bwd": ("partdistillation_torch/csrc/masked_attention_bwd.cu",
                                       "partdistillation_tpu/ops/fused_attention.py:79"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        c = checks[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "launches_inference_path": infer_launches[name],
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
