#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``partdistillation_torch``) on one GPU.

Phases, each printing one JSON line:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build: the hand-written kernels from ``partdistillation_torch/csrc``;
  3. per-kernel checks at every input shape the main paths give each kernel
     (B=2, bf16, 640^2): the kernel against its plain PyTorch version
     (max_abs_err within a stated tolerance), then kernel / plain /
     library-call times and the card's bound at the kernel's most frequent
     main-path shape (the LayerNorm at each of its seven, the LN->MLP
     kernel at each of its four, the window attention and the window
     attention + projection at each of their eight and the masked-attention
     backward at each of its three, all but the LN->MLP with the median of
     five reads and its range, the backward's library call by the device
     time of its kernels; the masked attention's launches alone on a
     prepared mask and its whole wrapper call); the window attention +
     projection's attention launch also bit for bit against the window
     attention kernel; the P-folded deformable sampling also bit for
     bit against its summation order in PyTorch (the kernel's fused
     multiply-adds emulated) and at ragged and off-map cases, timed
     at the encoder's shape and through its one-level wrapper at each level;
     its banded variant (the stage-3 CLI's default) on offsets planted so
     that a tenth or more of the attention mass leaves the band: banded and
     dense must differ first, then the banded kernel equals its grouped
     plain form bit for bit at the encoder's shape, ragged levels, 2-D tiles
     and an unaligned value, timed beside dense by device time;
     the per-tap deformable-sampling kernel, which no model path runs, at
     ragged and off-map cases and through ``tools/torch_msda_bench.py`` at
     each level (all sampling times medians of five reads);
  4. inference path: ``make_inference_fn`` on the full-width Swin-L +
     MSDeformAttn pixel decoder (deformable sampling kernel) + 9-layer
     masked decoder (seeded random weights) over three batches of synthetic
     images with GT and object masks, through ``ProposalEvaluator``;
     per-batch latency, images/s, peak memory and each kernel's launch count
     (must equal launches per forward x forwards);
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
     path's, which also decides a group whose two bf16 paths part (also read, not held, with only the deformable sampling swapped
     back: #7's share of that distance);
  8. unfrozen train path (this slice's path): the same train step with the
     trunk unfrozen and Swin's window attention fused with its output
     projection (``fused_proj=True``). At the seeded initial weights, the
     loss and the gradients per trunk group (each Swin stage's qkv / proj /
     relative-position table / MLP / norms, each MSDeformAttn layer's four
     projections, the rest of the pixel decoder) against the same step
     through the plain versions (same weights, batch, noise and matching),
     each group's distance to the same step in f32 through the plain
     versions held to the plain bf16 path's, and the same comparisons with
     the deformable sampling's d(locations) planted to zero, which must fail
     the sampling-offset groups on both; then two
     steps with per-step latency, peak memory, exact launch counts per step
     and every trunk parameter group moved;
  9. the CLI path: ``python -m partdistillation_torch.run train-proposal``
     in this process at its full-size default (banded sampling) over a
     synthetic ImageNet split, a stage-2b store and a PartImageNet-style
     json made here: four steps at B = 2, resumed to six, then
     ``eval-proposal --trainer-checkpoint``, then one step at B = 8; exact
     launch counts (every sampling launch banded), the trunk of every
     checkpoint bitwise the seeded initial weights, every decoder parameter
     moved, finite losses, AR@k in [0, 100], the out-of-band fraction per
     encoder layer, the loader's wait and the step time, peak memory;
 10. the stage-5 CLI path: ``train-distillation`` in this process at its
     full-size default (the 22,000 x 8 + 1 column part head) over
     phase 9's images and a synthetic stage-4 store (object classes spread
     over the head, two images of one class, one of the last class): four
     steps at B = 2, ``distill-save --trainer-checkpoint`` (the store read
     back: labels in [0, 8), scores in [0, 1]), ``distill-eval
     --trainer-checkpoint --num-gt-parts 40`` (the (22000, 8) mapping, the
     six metrics in [0, 100] or NaN), one step at B = 8; exact launch
     counts (every sampling launch banded), the trunk of every checkpoint
     bitwise the seeded initial weights, every decoder parameter moved,
     the head and its AdamW moments in the checkpoint, finite losses; then
     on one batch of three images the head's gradient nonzero in exactly
     the batch's live columns, and the loss (phase 7's limit) and the
     head's gradient over them (limits of its own) against the
     plain-version step;
 11. the k-means stages' CLIs over phase 9's images and checkpoint:
     ``propose`` (Swin-L bf16 alone, B = 2, k = 4) on a stage-1 store of each
     image's proposal union (every record 1-4 disjoint parts whose union is
     the object mask, its object ratio the mask's mean, the store read by
     the stage-3 mapper), ``eval-pixel-grouping`` (AR@k in [0, 100]),
     ``rank --phases cluster,save`` into a 22,000-class bank from phase 9's
     checkpoint (the bank finite, its few-sample classes ``RandomState(0)``'s
     draw bit for bit, the store's labels in [0, 8), scores in [0, 1], masks
     disjoint, read by the stage-5 join and mapper) and ``--phases
     match,eval`` (the (22000, 8) mapping in [0, 40), the six metrics); exact
     launch counts (every sampling launch banded); then the Lloyd fit on the
     card against the CPU's from the same seeding at the bank's chunk and at
     stage 2's batch, ``ClusteringModule.evaluate()`` on the card against the
     CPU's over 64 classes, two planted faults (the mask ignored in the
     update; the fit's inputs rounded to TF32) that must fail, and the
     seeding's and the Lloyd fit's times beside their bounds; the phase
     runs with both TF32 flags on, which the fit must not feel;
 12. the front of the pipeline over phase 9's images and checkpoint, with
     both TF32 flags on: ``detect`` (Swin-L bf16, 200 queries, 100
     proposals, top 10, B = 2; its store, at most 10 masks a record with
     scores in [0, 1], read by the stage-2 mapper), ``label`` over a
     detections store of detect's masks, ``eval-detect`` (AR@k in [0, 100]),
     ``propose`` on detect's store, ``dcrf`` on propose's store (disjoint
     masks, the object ratio the union's mean, read by the stage-3 and
     stage-4 mappers) and ``dcrf --watch`` over the complete store (the same
     records); exact launch counts; ``run_labeling_batched`` with the device
     CLIP scorer (ViT-B/32 bf16 from seeded weights; the f32 text tower's
     embeddings of 22,000 prompts of 77 tokens); the scorer against the same
     function in f32 on the CPU (class ids, probabilities; the text tower's
     embeddings too) and the dCRF against the CPU at 640^2 (Q, the refined
     masks), each with a planted fault that must fail (the crop boxes
     transposed, the colour term dropped); the dCRF's window setup and apply
     times beside their bounds; img/s and peak memory of each CLI;
 13. multi-GPU: (a) world 1 through NCCL, ``python -m torch.distributed.run
     --standalone --nproc-per-node 1`` running this script's
     ``--torchrun-cli`` rank, which calls ``partdistillation_torch.run.main``
     inside the process group: ``train-proposal`` and ``train-distillation``
     for four steps, ``eval-proposal``, ``rank`` (all four phases) and
     ``distill-eval`` over phases 9-11's data and checkpoints; exact launch
     counts, every sampling launch banded, the losses and the checkpoints
     bit for bit the single-process runs' of phases 9 and 10, the metrics
     phases 9-11's; img/s, step time and peak memory beside the
     single-process runs'; (b) ``tools/torch_ddp_check.py`` under torchrun
     with two ranks on this card through gloo on CUDA tensors: the
     data-parallel stage-3 step at B = 1 a rank against one process at
     B = 2 (loss and decoder gradient groups within limits read at seeds
     0-2), a planted per-rank mask count that must miss them, the gradient
     all-reduce's share of the step, and one stage-5 step with the part head
     sharded over the two ranks against the unsharded step;
 14. the supervised / fewshot ablation over phase 9's PartImageNet-style set
     and synthetic Pascal-Parts (VOC ``.mat``) and Cityscapes-Part (32-bit
     uid) sets: ``train-supervised`` at full width with the trunk unfrozen
     (40 part classes, the criterion's random point mode at 12544 points)
     for four steps at B = 2, resumed to six (exact launches, every #7
     banded; every trunk and decoder group moved; finite losses), the
     fewshot class-agnostic run (``--label-percentage 50
     --class-agnostic``), ``eval-supervised`` on each set (metrics in
     [0, 100] or NaN), the v1 heads (``--pixel-decoder fpn |
     transformer_fpn --decoder standard``: #4, #5, #7 not launched), ``rank
     --eval-dataset pascal`` on phase 9's checkpoint (``--phases save``
     refused) and ``distill-eval --eval-dataset cityscapes`` on phase 10's;
     then the criterion on the card against the CPU at the step's shapes
     (share of equal kept points, loss, gradients) with a planted fault
     (the uncertainty's sign flipped) that must fail, and the supervised
     step through the kernels against the plain versions;
 15. the tools around the pipeline over phase 9's data: ``doctor`` (ok on
     cuda, the kernel library and the host codec built), ``profile --steps
     3`` at full width (the unfrozen stage-3 step: exact launches over its
     warm-up and traced steps, the trace written, device time in the
     backbone, pixel decoder, transformer decoder and backward scopes; the
     top scopes printed), ``train-proposal`` with ``vis_every=2`` for four
     steps (launches of the steps plus two snapshot forwards, two PNGs of
     the collage's size), ``visualize`` over phase 9's dCRF store (the
     panel count, the PNG read back); the CLIP scorer with host crops
     against the device crops on phase 12's check (id agreement and the
     largest probability difference, within limits read at seeds 0-2 by
     ``tools/torch_host_crop_seeds.py``), and the host codec (built by
     this machine's g++) on every mask of phase 9's store, byte for byte
     the numpy codec's;
 16. a ``kernels`` line with every kernel's numbers and its launches on each
     path;
 17. the last line: {"ok": true, "device": {...}}.

Exits non-zero, with no result line, when no CUDA device is present, when a
kernel fails to build or launch, or when any check fails. Run from the
repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

BATCHES, BATCH_SIZE, IMAGE_SIZE = 3, 2, 640  # the main path: 3 batches of B=2 at 640^2
TRAIN_STEPS, MASK_SLOTS, PADDED_SLOTS = 4, 8, 2  # the train path: 4 steps, T = 8 (2 padded)
FREEZE_KEYS = ("backbone", "pixel_decoder")
TRUNK = ("backbone.", "sem_seg_head.pixel_decoder.")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


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
    from partdistillation_torch.utils.timing import (PEAK_F32_FLOPS, bound, device_ms, steady,
                                                     time_ms)

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

    # 1. LayerNorm (bf16 on the main path; f32 checked too); timed at each
    #    of its seven main-path shapes, ms and library_ms the median of five
    #    reads by events and by the device time of the kernels (device_ms,
    #    library_device_ms: at the small shapes the events time the host's
    #    wrapper call), the headline at the patch-norm / res2 rows
    #    (B*160*160 x 192)
    tol = 2.0 ** -7  # one bf16 rounding of the output (relative to max |y|)
    errs, by_shape = [], []
    for shape, dtype in [(s, bf) for s in ln_shapes] + [(ln_shapes[-1], torch.float32)]:
        x = randn(*shape, dtype=dtype)
        sc, bi = randn(shape[1], dtype=torch.float32), randn(shape[1], dtype=torch.float32)
        e = compare("layer_norm", lambda: ln.fused_layer_norm(x, sc, bi),
                    lambda: ln.layer_norm_plain(x, sc, bi), tol if dtype == bf else 1e-5)
        if dtype != bf:
            continue
        errs.append(e)
        rows, c = shape
        w_bf, b_bf = sc.to(bf), bi.to(bf)
        b = bound(2 * rows * c * 2 + 2 * c * 4, 8 * rows * c, PEAK_F32_FLOPS)
        kern = functools.partial(ln.fused_layer_norm, x, sc, bi)
        lib = functools.partial(F.layer_norm, x, (c,), w_bf, b_bf)
        row = dict(shape=[rows, c], plan=ln.layer_norm_plan(rows, c, bf, True),
                   bound_ms=b[0], bound_by=b[1], **steady("", kern),
                   **steady("device_", kern, timer=device_ms), **steady("library_", lib),
                   **steady("library_device_", lib, timer=device_ms))
        if [rows, c] == [2 * 160 * 160, 192]:
            row["plain_ms"] = time_ms(lambda: ln.layer_norm_plain(x, sc, bi))
            head = row
        by_shape.append(row)
    results["layer_norm"] = dict(
        **worst(errs, tol), shapes_checked=len(ln_shapes) + 1, shape=head["shape"],
        ms=head["ms"], ms_range=head["ms_range"], device_ms=head["device_ms"],
        device_ms_range=head["device_ms_range"], plain_ms=head["plain_ms"],
        library_ms=head["library_ms"], library_ms_range=head["library_ms_range"],
        bound=(head["bound_ms"], head["bound_by"]), by_shape=by_shape)

    # 2. fused LN->MLP at each stage, both add_residual values; timed at each
    #    stage's shape (all do n*C^2 = const work), the headline at res4
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

    def mlp_timing(t, c):
        x, g1, be, w1, b1, w2, b2 = a = mlp_inputs(t, c)

        def mlp_library():
            h = F.gelu(F.linear(F.layer_norm(x, (c,), g1, be), w1, b1))
            return x + F.linear(h, w2, b2)

        b = bound(2 * t * c * 2 + 2 * 4 * c * c * 2 + (6 * c) * 2, 16 * t * c * c)
        return dict(shape=[t, c], ms=time_ms(lambda: fm.fused_ln_mlp(*a)),
                    plain_ms=time_ms(lambda: fm.ln_mlp_kernel_numerics(*a)),
                    library_ms=time_ms(mlp_library), bound_ms=b[0], bound_by=b[1])

    by_shape = [mlp_timing(t, c) for t, c in mlp_shapes]
    head = next(r for r in by_shape if r["shape"] == [2 * 40 * 40, 768])
    results["fused_ln_mlp"] = dict(
        **worst(errs, tol), shapes_checked=2 * len(mlp_shapes), shape=head["shape"],
        ms=head["ms"], plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        bound=(head["bound_ms"], head["bound_by"]), by_shape=by_shape)

    # 3. window attention at each stage, unshifted (P=1) and shifted (P=nW);
    #    timed at each shape, ms and library_ms the median of five reads (with
    #    their min and max), the headline at the res2 shifted block
    #    (Bw = B*196, H=6, D=32, N=144, P=196)
    def win_inputs(bw, h, d, p):
        qt, kt, vt = (randn(bw, h, d, 144) for _ in range(3))
        return qt, kt, vt, randn(p, h, 144, 144, dtype=torch.float32)

    tol = 2.0 ** -6  # bf16 probabilities and output rounding (relative to max |o|)
    errs, by_shape = [], []
    for bw, h, d, p in win_shapes:
        qt, kt, vt, bias = win_inputs(bw, h, d, p)
        scale = d ** -0.5
        errs.append(compare(
            "fused_window_attention",
            lambda: fa.fused_window_attention(qt, kt, vt, bias, scale),
            lambda: fa.window_attention_plain(qt, kt, vt, bias, scale), tol))
        full_bias = bias.repeat_interleave(bw // p, dim=0).to(bf)
        qn, kn, vn = (t_.transpose(-1, -2) for t_ in (qt, kt, vt))
        b = bound(4 * bw * h * d * 144 * 2 + p * h * 144 * 144 * 4, 4 * bw * h * 144 * 144 * d)
        row = dict(shape=[bw, h, d, 144, p], bound_ms=b[0], bound_by=b[1],
                   **steady("", lambda: fa.fused_window_attention(qt, kt, vt, bias, scale)),
                   **steady("library_", lambda: F.scaled_dot_product_attention(
                       qn, kn, vn, attn_mask=full_bias, scale=scale)))
        if [bw, h, p] == [2 * 196, 6, 196]:
            row["plain_ms"] = time_ms(lambda: fa.window_attention_plain(qt, kt, vt, bias, scale))
            head = row
        by_shape.append(row)
        del full_bias
    results["fused_window_attention"] = dict(
        **worst(errs, tol), shapes_checked=len(win_shapes), shape=head["shape"][:4],
        ms=head["ms"], ms_range=head["ms_range"], plain_ms=head["plain_ms"],
        library_ms=head["library_ms"], library_ms_range=head["library_ms_range"],
        bound=(head["bound_ms"], head["bound_by"]), by_shape=by_shape)

    # 4. masked cross-attention: (2, 8, 200, 32) against each key count, the
    #    mask shared across heads as on the main path (and once per head),
    #    against the plain version and the plain split-and-merge at the
    #    kernel's split; its log-sum-exp against the f32 logsumexp of the
    #    same scores (1e-4 x max(1, |lse|): f32 sums in another order);
    #    timed at K = 6400
    tol = 2.0 ** -6  # bf16 exp(s - max) before P.V (relative to max |o|)
    errs, lse_errs = [], []
    for nk, mh in [(nk, 1) for nk in masked_keys] + [(masked_keys[0], 8)]:
        q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
        m = torch.rand((2, mh, 200, nk), generator=g, device=dev) < 0.6
        m[:, :, :5] = True  # all-blocked rows take the fix-up
        errs.append(compare("fused_masked_attention",
                            lambda: fa.fused_masked_attention(q, k, v, m),
                            lambda: fa.masked_attention_plain(q, k, v, m), tol))
        out, lse, _ = fa.masked_attention_fwd_lse(q, k, v, m)
        n_split = fa.masked_attention_plan(2, 8, 200, nk, 32)["n_split"]
        out_s, _ = fa.masked_attention_split_plain(q, k, v, m, n_split)
        compare(f"fused_masked_attention vs split plain K={nk}", lambda: out, lambda: out_s, tol)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        ref = torch.logsumexp(scores.masked_fill(m & ~m.all(-1, keepdim=True), float("-inf")), -1)
        lse_err = ((lse - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        if not np.isfinite(lse_err) or lse_err > 1e-4:
            fail(f"fused_masked_attention lse K={nk}: relative error {lse_err} > 1e-4")
        lse_errs.append(lse_err)
    # timed like for like with SDPA: the kernel's launches alone on a prepared
    # mask (``ms``), SDPA on a prepared additive mask (``library_ms``); and the
    # whole wrapper call with its mask preparation (``wrapper_ms``)
    nk = masked_keys[-1]
    q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
    m = torch.rand((2, 1, 200, nk), generator=g, device=dev) < 0.6
    add = torch.where(m & ~m.all(-1, keepdim=True), -1e9, 0.0).to(bf)
    prepared = fa._effective_mask(q, k, m)
    results["fused_masked_attention"] = dict(
        **worst(errs, tol), shapes_checked=len(masked_keys) + 1, shape=[2, 8, 200, nk, 32],
        ms=time_ms(lambda: fa._masked_fwd(q, k, v, prepared, None)),
        wrapper_ms=time_ms(lambda: fa.fused_masked_attention(q, k, v, m)),
        plain_ms=time_ms(lambda: fa.masked_attention_plain(q, k, v, m)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=add, scale=1.0)),
        splits=fa.masked_attention_plan(2, 8, 200, nk, 32)["n_split"],
        lse_rel_err=max(lse_errs),
        bound=bound((2 * 8 * 200 * 32 * 2) * 2 + 2 * (2 * 8 * nk * 32 * 2) + 2 * 200 * nk,
                    4 * 2 * 8 * 200 * nk * 32))

    # 5. masked cross-attention backward: the same shapes, mask shared across
    #    heads and once per head at every key count, against the plain
    #    backward and the plain split algorithm at the kernel's plan; timed
    #    with the shared mask (the main path's) at each key count, ms and
    #    library_ms the median of five reads (library_ms by device time), the
    #    headline at K = 6400
    tol = 2.0 ** -6  # bf16 P, dS and gradient roundings (relative to max |plain|)
    errs, by_shape = [], []
    for nk in masked_keys:
        for mh in (1, 8):
            q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
            g_out = randn(2, 8, 200, 32)
            m = torch.rand((2, mh, 200, nk), generator=g, device=dev) < 0.6
            m[:, :, :5] = True
            out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, m)
            got = fa.fused_masked_attention_bwd(q, k, v, mask, out, lse, g_out)
            want = fa.masked_attention_bwd_plain(q, k, v, m, g_out)
            split = fa.masked_attention_bwd_split_plain(q, k, v, mask, out, lse, g_out)
            for which, a, b, c in zip(("dq", "dk", "dv"), got, want, split):
                errs.append(compare(f"fused_masked_attention_bwd {which} K={nk} mask_heads={mh}",
                                    lambda a=a: a, lambda b=b: b, tol))
                compare(f"fused_masked_attention_bwd {which} vs split plain K={nk} "
                        f"mask_heads={mh}", lambda a=a: a, lambda c=c: c, tol)
    for nk in masked_keys:
        q, k, v = randn(2, 8, 200, 32, scale=32 ** -0.5), randn(2, 8, nk, 32), randn(2, 8, nk, 32)
        g_out = randn(2, 8, 200, 32)
        m = torch.rand((2, 1, 200, nk), generator=g, device=dev) < 0.6
        out, lse, mask = fa.masked_attention_fwd_lse(q, k, v, m)
        add = torch.where(m & ~m.all(-1, keepdim=True), -1e9, 0.0).to(bf)
        ql, kl, vl = (t_.clone().requires_grad_() for t_ in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=add, scale=1.0)
        bhq, bhk = 2 * 8 * 200, 2 * 8 * nk
        # read q, g, o, k, v (bf16), lse (f32), the uint8 mask; write dq, dk, dv
        b = bound(3 * bhq * 32 * 2 + 2 * bhk * 32 * 2 + bhq * 4 + 2 * 200 * nk
                  + bhq * 32 * 2 + 2 * bhk * 32 * 2, 10 * 2 * 8 * 200 * nk * 32)
        # the library backward by the device time of its kernels (its wall
        # time through autograd.grad is the host's); the kernel's three
        # launches by device time too (device_ms), beside its event time
        row = dict(shape=[2, 8, 200, nk, 32], bound_ms=b[0], bound_by=b[1],
                   plan=fa.masked_attention_bwd_plan(2, 8, 200, nk, 32),
                   **steady("", lambda: fa.fused_masked_attention_bwd(
                       q, k, v, mask, out, lse, g_out)),
                   **steady("device_", lambda: fa.fused_masked_attention_bwd(
                       q, k, v, mask, out, lse, g_out), timer=device_ms),
                   **steady("library_", lambda: torch.autograd.grad(
                       lib_out, (ql, kl, vl), g_out, retain_graph=True), timer=device_ms))
        if nk == masked_keys[-1]:
            row["plain_ms"] = time_ms(lambda: fa.masked_attention_bwd_plain(q, k, v, m, g_out))
            head = row
        by_shape.append(row)
    results["fused_masked_attention_bwd"] = dict(
        **worst(errs, tol), shapes_checked=2 * len(masked_keys), shape=head["shape"],
        ms=head["ms"], ms_range=head["ms_range"], device_ms=head["device_ms"],
        device_ms_range=head["device_ms_range"], plain_ms=head["plain_ms"],
        library_ms=head["library_ms"], library_ms_range=head["library_ms_range"],
        bound=(head["bound_ms"], head["bound_by"]), by_shape=by_shape)

    # 6. window attention + output projection at each stage, unshifted and
    #    shifted (C = H x D): against the plain version, and its attention
    #    launch bit for bit against the window attention kernel (#3) after a
    #    transpose; timed at each shape as the LayerNorm, the headline at the
    #    res4 shifted block (Bw = B*16, H=24, C=768)
    def proj_inputs(bw, h, d, p):
        c = h * d
        return (*win_inputs(bw, h, d, p), randn(c, c, scale=c ** -0.5), randn(c, scale=0.1))

    tol = 2.0 ** -6  # bf16 probabilities, attention output and output roundings
    errs, by_shape = [], []
    for bw, h, d, p in win_shapes:
        a = proj_inputs(bw, h, d, p)
        qt, kt, vt, bias, w, b_ = a
        c, scale = h * d, d ** -0.5
        errs.append(compare("fused_window_attention_proj",
                            lambda: fa.fused_window_attention_proj(*a, scale=scale),
                            lambda: fa.window_attention_proj_plain(*a, scale=scale), tol))
        plan = fa.window_attention_proj_plan(bw, h, d, 144, c, p)
        attn = fa._window_proj_attention(qt, kt, vt, bias, scale, plan["ctas"])
        ref = fa.fused_window_attention(qt, kt, vt, bias, scale)
        torch.cuda.synchronize()
        if not torch.equal(attn, ref.permute(0, 3, 1, 2).reshape(bw * 144, c)):
            fail(f"fused_window_attention_proj {[bw, h, d, p]}: the attention launch differs "
                 "from the window attention kernel")
        del attn, ref
        full_bias = bias.repeat_interleave(bw // p, dim=0).to(bf)
        qn, kn, vn = (t_.transpose(-1, -2) for t_ in (qt, kt, vt))

        def proj_library():
            o = F.scaled_dot_product_attention(qn, kn, vn, attn_mask=full_bias, scale=scale)
            return F.linear(o.transpose(1, 2).reshape(bw, 144, c), w, b_)

        b = bound(3 * bw * h * d * 144 * 2 + p * h * 144 * 144 * 4 + c * c * 2 + c * 2
                  + bw * 144 * c * 2,
                  4 * bw * h * 144 * 144 * d + 2 * bw * 144 * c * c)
        kern = functools.partial(fa.fused_window_attention_proj, *a, scale=scale)
        row = dict(shape=[bw, h, d, 144, c, p], plan=plan, bound_ms=b[0], bound_by=b[1],
                   **steady("", kern), **steady("device_", kern, timer=device_ms),
                   **steady("library_", proj_library),
                   **steady("library_device_", proj_library, timer=device_ms))
        if [bw, h, p] == [2 * 16, 24, 16]:
            row["plain_ms"] = time_ms(lambda: fa.window_attention_proj_plain(*a, scale=scale))
            head = row
        by_shape.append(row)
        del full_bias
    results["window_attention_proj"] = dict(
        **worst(errs, tol), shapes_checked=len(win_shapes),
        shape=head["shape"][:5], ms=head["ms"], ms_range=head["ms_range"],
        device_ms=head["device_ms"], device_ms_range=head["device_ms_range"],
        plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        library_ms_range=head["library_ms_range"], bound=(head["bound_ms"], head["bound_by"]),
        by_shape=by_shape)

    # 7. deformable sampling, P-folded, all levels in one launch at the
    #    encoder's shape (value (2, 8400, 8, 32), taps within a few pixels of
    #    each query's reference point, some off the map; bf16 weights as the
    #    model makes them), against the plain version and, bit for bit,
    #    the kernel's order and rounding (msda_folded_grouped_plain); then
    #    ragged and off-map cases, and the one-level wrapper at each level. Timed at the
    #    encoder's shape and per level (medians of five reads)
    from partdistillation_torch.models.pixel_decoder import _reference_points
    from partdistillation_torch.ops import msda_sampling as ms

    tol = 2.0 ** -7  # one bf16 rounding of the output (f32 sums in another order)
    levels = msda_levels()
    s_len, heads, pts = sum(hh * ww for hh, ww in levels), 8, 4
    value = randn(2, s_len, heads, 32)
    ref = _reference_points(levels, dev)[None, :, None, :, None, :]
    size = torch.tensor([[ww, hh] for hh, ww in levels], dtype=torch.float32, device=dev)
    offsets = (torch.rand((2, s_len, heads, len(levels), pts, 2), generator=g, device=dev)
               * 8.0 - 4.0) / size[None, None, None, :, None, :]
    loc = ref + offsets
    attw = torch.softmax(randn(2, s_len, heads, len(levels) * pts, dtype=torch.float32),
                         -1).reshape(2, s_len, heads, len(levels), pts).to(bf)
    errs = [compare("msda_folded", lambda: ms.msda_folded(value, levels, loc, attw),
                    lambda: ms.msda_folded_plain(value, levels, loc, attw), tol)]
    same_bits("msda_folded vs grouped plain", ms.msda_folded(value, levels, loc, attw),
              ms.msda_folded_grouped_plain(value, levels, loc, attw))
    for case in msda_extra_cases():
        errs.extend(msda_folded_case(compare, randn, g, tol, *case))
    for hh, ww in levels:
        v1 = randn(16, hh * ww, 32)
        x1 = torch.rand((16, pts, s_len), generator=g, device=dev) * (ww + 3.0) - 2.0
        y1 = torch.rand((16, pts, s_len), generator=g, device=dev) * (hh + 3.0) - 2.0
        a1 = torch.rand((16, pts, s_len), generator=g, device=dev)
        errs.append(compare("sample_level_folded",
                            lambda: ms.sample_level_folded(v1, x1, y1, a1, hh, ww),
                            lambda: ms.sample_level_folded_plain(v1, x1, y1, a1, hh, ww), tol))
    grids = [(2 * loc[:, :, :, i] - 1).transpose(1, 2).flatten(0, 1).to(bf)
             for i in range(len(levels))]  # (B*M, Lq, P, 2) per level
    v_levels = [lv.flatten(2).transpose(1, 2).reshape(2 * heads, 32, hh, ww)
                for lv, (hh, ww) in zip(value.split([hh * ww for hh, ww in levels], dim=1),
                                        levels)]
    attw_cf = attw.transpose(1, 2).reshape(2 * heads, 1, s_len, len(levels) * pts)

    def msda_library():  # the reference's ms_deform_attn_core_pytorch
        sampled = [F.grid_sample(vl, gl, mode="bilinear", padding_mode="zeros",
                                 align_corners=False) for vl, gl in zip(v_levels, grids)]
        out = (torch.stack(sampled, dim=-2).flatten(-2) * attw_cf).sum(-1)
        return out.view(2, heads * 32, s_len).transpose(1, 2)

    n_taps = 2 * s_len * heads * len(levels) * pts
    # read value, the f32 locations, the bf16 weights; write the output
    b = bound(value.numel() * 2 + loc.numel() * 4 + attw.numel() * 2 + value.numel() * 2,
              8 * 32 * n_taps, PEAK_F32_FLOPS)
    head = dict(shape=[2, s_len, heads, 32], levels=levels, bound_ms=b[0], bound_by=b[1],
                **steady("", lambda: ms.msda_folded(value, levels, loc, attw)),
                **steady("device_", functools.partial(ms.msda_folded, value, levels, loc, attw),
                         timer=device_ms),
                plain_ms=time_ms(lambda: ms.msda_folded_plain(value, levels, loc, attw)),
                **steady("library_", msda_library))
    bench = msda_bench()
    by_shape = [head]
    for hh, ww in levels:  # the one-level wrapper (B*M = 16, P = 4, N = 8400)
        row = bench.bench_folded(hh, ww, seed)
        by_shape.append({key: row[key] for key in (
            "kernel", "level", "shape", "ms", "ms_range", "plain_ms", "library_ms",
            "library_ms_range", "bound_ms", "bound_by")})
    banded = msda_banded_checks(compare, randn, g, tol, value, attw)
    results["msda_folded"] = dict(
        **worst(errs + banded.pop("errs"), tol),
        shapes_checked=2 + len(msda_extra_cases()) + len(levels) + 1 + len(msda_banded_cases()),
        shape=head["shape"], ms=head["ms"], ms_range=head["ms_range"],
        device_ms=head["device_ms"], device_ms_range=head["device_ms_range"],
        plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        library_ms_range=head["library_ms_range"], bound=b, by_shape=by_shape, banded=banded)

    # 8/9. deformable sampling per tap (one kernel for both TPU rows): ragged
    #    and off-map cases, then the bench tool at each level, its only entry
    #    point (medians of five reads), the headline at 80^2
    errs = []
    for case in taps_extra_cases():
        errs.extend(taps_case(compare, randn, g, tol, *case))
    by_shape, launches = [], 0
    for hh, ww in reversed(levels):
        row = bench.bench_taps(hh, ww, seed)
        errs.append((row["max_abs_err"], row["rel_err"]))
        launches += row["launches"]
        by_shape.append({key: row[key] for key in (
            "level", "shape", "ms", "ms_range", "plain_ms", "library_ms", "library_ms_range",
            "bound_ms", "bound_by")})
    head = by_shape[0]
    results["msda_taps"] = dict(
        **worst(errs, tol), shapes_checked=len(errs), shape=head["shape"], ms=head["ms"],
        ms_range=head["ms_range"], plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        library_ms_range=head["library_ms_range"], bound=(head["bound_ms"], head["bound_by"]),
        by_shape=by_shape, launches_bench=launches)
    return results


BAND_RADIUS, BAND_TILE = 4, 512  # the stage-3 CLI's full-size default
BAND_SPREAD = 12.0  # planted offsets, level pixels: a tenth or more of the mass out of band


def msda_banded_cases():
    """Banded cases (levels, B, M, D, P, radius, tile_queries, tile_x,
    misaligned value): ragged levels with 1-D row bands, 2-D tiles (with D =
    6: 2-byte loads), and a value at an address off 8 bytes (2-byte loads,
    one lane group)."""
    return [(((15, 11), (8, 6), (4, 3)), 2, 3, 16, 3, 1, 22, None, False),
            (((16, 12), (8, 6), (4, 3)), 1, 2, 32, 2, 1, 512, 4, False),
            (((9, 31), (5, 16), (3, 8)), 2, 2, 6, 2, 1, 512, 3, False),
            (((40, 40), (20, 20), (10, 10)), 1, 8, 32, 4, 2, 128, None, True)]


def planted_locations(g, levels, b, m, p, spread=BAND_SPREAD):
    """(B, S, M, L, P, 2) locations around each query's reference point
    (queries = pixels) with offsets uniform in +-spread level pixels."""
    import torch

    from partdistillation_torch.models.pixel_decoder import _reference_points

    dev = torch.device("cuda")
    s = sum(hh * ww for hh, ww in levels)
    ref = _reference_points(levels, dev)[None, :, None, :, None, :]
    size = torch.tensor([[ww, hh] for hh, ww in levels], dtype=torch.float32, device=dev)
    u = torch.rand((b, s, m, len(levels), p, 2), generator=g, device=dev)
    return ref + (u * 2 * spread - spread) / size[None, None, None, :, None, :]


def banded_case(compare, tol, value, levels, loc, attw, radius, tile_queries, tile_x,
                aligned=True, name="msda_folded banded"):
    """The banded kernel on planted offsets: first the out-of-band mass
    (>= 10 %) and banded against dense by more than the tolerance (a kernel
    that ignored the band would fail what follows), then bit for bit
    against its grouped plain form and within ``tol`` of the plain banded
    version. Returns (band, oob fraction, (err, rel_err))."""
    import torch

    from partdistillation_torch.ops import ms_deform_attn as msda
    from partdistillation_torch.ops import msda_sampling as ms

    band = msda.msda_band_table(levels, radius, tile_queries, tile_x, value.device)
    oob = float(msda.msda_band_oob_fraction(levels, loc, attw, radius, tile_queries, tile_x))
    if oob < 0.1:
        fail(f"{name}: planted offsets carry {oob:.3f} of the mass out of band (< 0.1)")
    out = ms.msda_folded(value, levels, loc, attw, band=band)
    dense = ms.msda_folded(value, levels, loc, attw)
    torch.cuda.synchronize()
    gap = (out.float() - dense.float()).abs().max().item()
    if not gap > 10 * tol * dense.float().abs().max().item():
        fail(f"{name}: banded and dense differ by {gap} only: the band does not act")
    same_bits(f"{name} vs grouped banded plain", out,
              ms.msda_folded_banded_grouped_plain(value, levels, loc, attw, band, aligned))
    err = compare(name, lambda: ms.msda_folded(value, levels, loc, attw, band=band),
                  lambda: ms.msda_folded_banded_plain(value, levels, loc, attw, band), tol)
    return band, oob, err


def msda_banded_checks(compare, randn, g, tol, value, attw):
    """#7's banded variant: at the encoder's shape (the CLI's radius 4 and
    512-query tiles) on planted offsets, then ``msda_banded_cases``; timed
    at the encoder's shape beside dense #7 on the same inputs (device time,
    median of five reads)."""
    import torch

    from partdistillation_torch.ops import msda_sampling as ms
    from partdistillation_torch.utils.timing import (PEAK_F32_FLOPS, bound, device_ms, steady,
                                                     time_ms)

    levels = msda_levels()
    b, _, m, _ = value.shape
    p = attw.shape[-1]
    loc = planted_locations(g, levels, b, m, p)
    band, oob, err = banded_case(compare, tol, value, levels, loc, attw, BAND_RADIUS,
                                 BAND_TILE, None)
    errs = [err]
    for levels_c, b_c, m_c, d_c, p_c, radius, tq, tx, misaligned in msda_banded_cases():
        s_c = sum(hh * ww for hh, ww in levels_c)
        v = randn(b_c, s_c, m_c, d_c)
        if misaligned:  # one element in: the kernel takes its 2-byte, one-group path
            buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
            buf[1:].copy_(v.flatten())
            v = buf[1:].view(v.shape)
        a = torch.softmax(randn(b_c, s_c, m_c, len(levels_c) * p_c, dtype=torch.float32),
                          -1).reshape(b_c, s_c, m_c, len(levels_c), p_c).to(torch.bfloat16)
        lc = planted_locations(g, levels_c, b_c, m_c, p_c)
        errs.append(banded_case(compare, tol, v, levels_c, lc, a, radius, tq, tx,
                                aligned=not misaligned,
                                name=f"msda_folded banded {levels_c} D={d_c} tile_x={tx}"
                                     f"{' misaligned' if misaligned else ''}")[2])
    n_taps = attw.numel()
    nbytes = (value.numel() * 2 + loc.numel() * 4 + attw.numel() * 2 + value.numel() * 2
              + band.numel() * 4)
    bnd = bound(nbytes, 8 * value.shape[-1] * n_taps, PEAK_F32_FLOPS)
    kern = functools.partial(ms.msda_folded, value, levels, loc, attw, band=band)
    dense = functools.partial(ms.msda_folded, value, levels, loc, attw)
    return dict(radius=BAND_RADIUS, tile_queries=BAND_TILE, planted_spread_px=BAND_SPREAD,
                oob_fraction=oob, max_abs_err=err[0], rel_err=err[1], errs=errs,
                cases_checked=1 + len(msda_banded_cases()), band_table_bytes=band.numel() * 4,
                **steady("", kern), **steady("device_", kern, timer=device_ms),
                **{k.replace("device_", "dense_device_"): v
                   for k, v in steady("device_", dense, timer=device_ms).items()},
                plain_ms=time_ms(lambda: ms.msda_folded_banded_plain(value, levels, loc, attw,
                                                                     band)),
                bound_ms=bnd[0], bound_by=bnd[1])


def msda_extra_cases():
    """Ragged and off-map P-folded cases (levels, B, Lq, M, D, P, placement,
    weights f32): ragged Lq, levels wider than a warp and 1 x 1, L x P of 4,
    9 and 40 (more than 32 lanes), D of 8, 16, 64 and 6 (2-byte loads),
    taps across the edges (x0 = -1 and x0 = W - 1) and wholly off the map."""
    three = ((3, 37), (1, 1), (7, 5))
    eight = ((4, 6), (3, 3), (2, 5), (1, 1), (7, 2), (2, 2), (5, 5), (1, 3))
    return [(three, 1, 45, 3, 16, 3, "spread", True), (((5, 7),), 2, 29, 3, 8, 4, "edge", False),
            (eight, 1, 77, 2, 32, 5, "spread", False), (eight, 2, 13, 2, 64, 5, "edge", True),
            (three, 2, 33, 2, 6, 2, "spread", True), (((9, 70),), 3, 17, 2, 32, 4, "off", False)]


def msda_folded_case(compare, randn, g, tol, levels, b, lq, m, d, p, placement, f32_weights):
    """One ragged or off-map case of the P-folded kernel against the plain
    version and, bit for bit, the kernel's order; taps wholly off the map must
    read exactly zero. Returns the (err, rel_err) against the plain version."""
    import torch

    from partdistillation_torch.ops import msda_sampling as ms

    dev = torch.device("cuda")
    s = sum(hh * ww for hh, ww in levels)
    value = randn(b, s, m, d)
    shape = (b, lq, m, len(levels), p)
    hw = torch.tensor(levels, dtype=torch.float32, device=dev)  # (L, 2) as (h, w)
    px = edge_pixels(g, shape, hw[:, 1].reshape(1, 1, 1, -1, 1), placement)
    py = edge_pixels(g, shape, hw[:, 0].reshape(1, 1, 1, -1, 1), placement)
    loc = torch.stack([(px + 0.5) / hw[:, 1].reshape(1, 1, 1, -1, 1),
                       (py + 0.5) / hw[:, 0].reshape(1, 1, 1, -1, 1)], -1)
    attw = torch.softmax(randn(b, lq, m, len(levels) * p, dtype=torch.float32), -1)
    attw = attw.reshape(shape).to(torch.float32 if f32_weights else torch.bfloat16)
    name = f"msda_folded levels={len(levels)} D={d} P={p} {placement}"
    if placement == "off":
        out = ms.msda_folded(value, levels, loc, attw)
        torch.cuda.synchronize()
        if not torch.equal(out, torch.zeros_like(out)):
            fail(f"{name}: taps wholly off the map did not read zero")
        return []
    same_bits(f"{name} vs grouped plain", ms.msda_folded(value, levels, loc, attw),
              ms.msda_folded_grouped_plain(value, levels, loc, attw))
    return [compare(name, lambda: ms.msda_folded(value, levels, loc, attw),
                    lambda: ms.msda_folded_plain(value, levels, loc, attw), tol)]


def same_bits(name, out, grouped):
    """The P-folded kernel against ``msda_folded_grouped_plain``, which sums
    in the kernel's order with its fused multiply-add: equal bit for bit."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(out, grouped):
        diff = (out.float() - grouped.float()).abs()
        fail(f"{name}: {int((diff > 0).sum())} of {diff.numel()} values differ "
             f"(max {diff.max().item()})")


def edge_pixels(g, shape, size, placement):
    """Pixel coordinates on a map of ``size`` (broadcast to ``shape``):
    "spread" from two pixels before to two beyond the map; "edge" with
    x0 = -1 or x0 = size - 1, wholly outside or inside in equal shares;
    "off" two to five pixels beyond either edge."""
    import torch

    dev = torch.device("cuda")
    u = torch.rand(shape, generator=g, device=dev)
    if placement == "spread":
        return u * (size + 4.0) - 2.0
    if placement == "off":
        return torch.where(u < 0.5, -2.0 - 3.0 * u, size + 1.0 + 3.0 * u)
    frac = 0.1 + 0.8 * torch.rand(shape, generator=g, device=dev)
    kind = torch.randint(0, 5, shape, generator=g, device=dev)
    base = torch.floor(u * size)
    base = torch.where(kind == 0, -1.0, torch.where(kind == 1, size - 1.0, base))
    base = torch.where(kind == 2, -3.0, torch.where(kind == 3, size + 1.0, base))
    return base + frac


def taps_extra_cases():
    """Ragged and off-map per-tap cases (BM, N, H, W, D, placement,
    misaligned map): N off a multiple of 32 and below a warp, a 1 x 1 map,
    D of 16, 64, 128 and 6 (2-byte loads), a map at an odd address (2-byte
    loads), taps across the edges and wholly off the map."""
    return [(3, 1001, 6, 45, 16, "spread", False), (5, 7, 1, 1, 32, "spread", False),
            (2, 333, 7, 3, 64, "edge", False), (2, 100, 5, 9, 128, "edge", False),
            (3, 250, 4, 4, 6, "spread", False), (2, 301, 80, 80, 32, "edge", True),
            (2, 97, 8, 8, 32, "off", False)]


def taps_case(compare, randn, g, tol, bm, n, h, w, d, placement, misaligned):
    """One ragged or off-map case of the per-tap kernel against its plain
    version; taps wholly off the map must read exactly zero."""
    import torch

    from partdistillation_torch.ops import msda_sampling as ms

    v = randn(bm, w, h * d)
    if misaligned:  # one element in: the kernel must take its 2-byte path
        buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
        buf[1:].copy_(v.flatten())
        v = buf[1:].view(bm, w, h * d)
    x, y = edge_pixels(g, (bm, n), w, placement), edge_pixels(g, (bm, n), h, placement)
    a = torch.rand((bm, n), generator=g, device=v.device)
    name = f"msda_taps N={n} {h}x{w} D={d} {placement}{' misaligned' if misaligned else ''}"
    if placement == "off":
        out = ms.sample_level(v, x, y, a, h, w)
        torch.cuda.synchronize()
        if not torch.equal(out, torch.zeros_like(out)):
            fail(f"{name}: taps wholly off the map did not read zero")
        return []
    return [compare(name, lambda: ms.sample_level(v, x, y, a, h, w),
                    lambda: ms.sample_level_plain(v, x, y, a, h, w), tol)]


def msda_levels():
    """The pixel decoder's levels (res5, res4, res3 at 640^2): (20, 20),
    (40, 40), (80, 80)."""
    return tuple((IMAGE_SIZE // stride, IMAGE_SIZE // stride) for stride in (32, 16, 8))


def msda_bench():
    """``tools/torch_msda_bench.py`` as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tools" / "torch_msda_bench.py"
    spec = importlib.util.spec_from_file_location("torch_msda_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


# launches per forward: 32 LayerNorms, 24 MLP halves and 24 window
# attentions (Swin-L's blocks), one deformable sampling of all three levels
# per encoder layer, one masked attention per decoder layer; no per-tap
# sampling
PER_FORWARD = {"layer_norm": 32, "fused_ln_mlp": 24, "fused_window_attention": 24,
               "fused_masked_attention": 9, "fused_masked_attention_bwd": 0,
               "window_attention_proj": 0, "msda_folded": 6, "msda_taps": 0}
# per train step: the same forward (23 of the 24 MLP launches in the branch
# form of the DropPath blocks) and one backward launch per decoder layer; the
# trunk kernels' gradients are their plain versions' VJPs (no launches)
PER_TRAIN_STEP = {**PER_FORWARD, "fused_masked_attention_bwd": 9}
# the unfrozen step with fused_proj: the fused window attention + projection
# kernel at all 24 blocks, res5 included, and the two-step kernel nowhere
PER_UNFROZEN_STEP = {**PER_TRAIN_STEP, "fused_window_attention": 0,
                     "window_attention_proj": 24}


def wrappers():
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln
    from partdistillation_torch.ops import msda_sampling as ms

    return {"layer_norm": ln.fused_layer_norm, "fused_ln_mlp": fm.fused_ln_mlp,
            "fused_window_attention": fa.fused_window_attention,
            "fused_masked_attention": fa.fused_masked_attention,
            "fused_masked_attention_bwd": fa.fused_masked_attention_bwd,
            "window_attention_proj": fa.fused_window_attention_proj,
            "msda_folded": ms.msda_folded, "msda_taps": ms.sample_level}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["msda_folded"].banded_launches = 0


def banded_launches() -> int:
    return wrappers()["msda_folded"].banded_launches


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


@contextlib.contextmanager
def plain_versions(kernels=None):
    """Swap each kernel wrapper the models call (those named in ``kernels``,
    by default all) for its plain version."""
    from partdistillation_torch.models import attention, swin
    from partdistillation_torch.ops import fused_attention as fa
    from partdistillation_torch.ops import fused_mlp as fm
    from partdistillation_torch.ops import layer_norm as ln
    from partdistillation_torch.ops import ms_deform_attn as msda
    from partdistillation_torch.ops import msda_sampling as ms

    swaps = {"layer_norm": (swin, "fused_layer_norm", ln.layer_norm_plain),
             "fused_ln_mlp": (swin, "fused_ln_mlp", fm.ln_mlp_kernel_numerics),
             "fused_window_attention": (swin, "fused_window_attention",
                                        fa.window_attention_plain),
             "window_attention_proj": (swin, "fused_window_attention_proj",
                                       fa.window_attention_proj_plain),
             "fused_masked_attention": (attention, "fused_masked_attention",
                                        fa.masked_attention_plain),
             "msda_folded": (msda, "msda_folded", ms.msda_folded_plain)}
    swaps = [swap for name, swap in swaps.items() if kernels is None or name in kernels]
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

    reset_launches()
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
    launches = launch_counts()
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
    for name, n in launch_counts().items():
        if n != launches[name] + PER_FORWARD[name]:
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


def compare_grads(got, want, parts=_decoder_parts):
    """Per group of ``parts(name, grad) -> [(group, piece), ...]``: relative
    error and cosine of got against want."""
    import torch

    pieces = {}
    for name in want:
        for (group, a), (_, b) in zip(parts(name, got[name]), parts(name, want[name])):
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
# the largest readings of sound runs on an H100 80GB HBM3 at 700 W at seeds
# 0-6, with the masked-attention forward and the LN -> MLP kernel both before
# and after their redesign (PERF.md). The groups these limits decide, where
# the kernel path is the further from the f32 step, read at most 0.150 and
# cosine 0.9893 (seed 4; seed 5 before the redesign, 0.101 and 0.9949); at
# either seed swapping any one of several kernels back to its plain version
# brings the f32 ratios to about 1: no kernel carries it, a change below one
# bf16 rounding upstream moves these gradients that far. The q and k
# projections of the cross-attention get their gradient through
# dS = P (dP - D) alone, a difference of near-equal terms that bf16 rounds
# differently in the kernel (f32 dP, D from the bf16 output) and in the plain
# version's autograd (dP rounded to bf16 at the probabilities' cast): they
# have limits of their own (read at most 0.230, cosine 0.9746). The loss read
# at most 2.9e-3.
SCORE_GROUPS = ("cross_attention_q", "cross_attention_k")
SCORE_REL_ERR_LIMIT, SCORE_COSINE_LIMIT = 0.46, 0.949
GRAD_REL_ERR_LIMIT, GRAD_COSINE_LIMIT = 0.30, 0.978
LOSS_REL_ERR_LIMIT = 0.006
# Against the same step in f32 through the plain versions, each group of the
# kernel path may be at most this many times as far off as the plain bf16
# path: 1 + twice the largest excess read at seeds 0-6 (1.69, seed 4). A
# planted dK = 0 reads 3.6-8.9.
F32_DISTANCE_RATIO_LIMIT = 2.4


def within_limits(cmp, ratios) -> bool:
    """Each group within its kernel-vs-plain limits, or with the kernel path
    no further from the f32 step than the plain bf16 path: where the two bf16
    paths part (seed 4: 0.18-0.42 apart, the plain path 0.22-0.41 from f32
    and the kernel path 0.53-0.62 times that), the f32 step decides."""
    def ok(group, v):
        rel, cos = ((SCORE_REL_ERR_LIMIT, SCORE_COSINE_LIMIT) if group in SCORE_GROUPS
                    else (GRAD_REL_ERR_LIMIT, GRAD_COSINE_LIMIT))
        return (v["rel_err"] <= rel and v["cosine"] >= cos) or ratios[group] <= 1.0
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

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    latencies, steps = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
        steps.append(metrics)
    launches = launch_counts()
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
    counts = launch_counts()
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
    if launch_counts() != counts:
        fail("the plain-version train step launched a kernel")
    # the kernel path with the deformable sampling alone swapped back for its
    # plain version: the share of #7 in the kernel path's distance to f32
    with plain_versions(("msda_folded",)):
        _, grads_km = loss_and_grads()
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
    ratios_plain_msda = f32_distance_ratios(compare_grads(grads_km, grads_32), plain_32)
    planted_ratios = f32_distance_ratios(compare_grads(grads_f, grads_32), plain_32)
    ok = (loss_rel <= LOSS_REL_ERR_LIMIT and within_limits(cmp, ratios)
          and max(ratios.values()) <= F32_DISTANCE_RATIO_LIMIT)
    planted_rejected = (not within_limits(planted, planted_ratios)
                        and max(planted_ratios.values()) > F32_DISTANCE_RATIO_LIMIT)
    emit({"phase": "kernels_vs_plain_train_step",
          "tolerance": f"total_loss within {LOSS_REL_ERR_LIMIT}; per decoder group (the "
                       f"cross-attention split into q / k / v / out / norm) gradient "
                       f"|g_kernel - g_plain| / |g_plain| <= {GRAD_REL_ERR_LIMIT} and cosine "
                       f">= {GRAD_COSINE_LIMIT}, for {', '.join(SCORE_GROUPS)} "
                       f"<= {SCORE_REL_ERR_LIMIT} and >= {SCORE_COSINE_LIMIT}, or "
                       f"|g_kernel - g_f32| <= |g_plain - g_f32|; per group "
                       f"|g_kernel - g_f32| <= {F32_DISTANCE_RATIO_LIMIT} x |g_plain - g_f32|",
          "total_loss_kernel": loss_k, "total_loss_plain": loss_p, "total_loss_f32": loss_32,
          "total_loss_rel_err": loss_rel, "groups": cmp,
          "plain_vs_f32": plain_32, "f32_distance_ratio": ratios,
          "f32_distance_ratio_with_plain_msda": ratios_plain_msda,
          "planted_dk_zero": planted, "planted_dk_zero_f32_distance_ratio": planted_ratios,
          "planted_fault_rejected": planted_rejected, "ok": ok})
    if not ok:
        fail("kernel train step disagrees with the plain-version train step")
    if not planted_rejected:
        fail("the train-step check passed a backward with dK set to zero")
    return launches


# --------------------------------------------------------------- phase 8


UNFROZEN_STEPS = 2


def unfrozen_config():
    """``train_config()`` with the trunk unfrozen (the train-proposal CLI's
    --no-freeze-trunk) and Swin's window attention fused with its output
    projection."""
    import dataclasses

    cfg = train_config()
    seg = cfg.segmenter
    seg = dataclasses.replace(seg, freeze_backbone=False, freeze_pixel_decoder=False,
                              swin=dataclasses.replace(seg.swin, fused_proj=True))
    return dataclasses.replace(cfg, segmenter=seg)


def trunk_group(name: str):
    """The trunk group of a parameter, or None for the decoder's: each Swin
    stage's qkv / proj / rel_pos_table / mlp / norms (the stage's output
    norm included) / downsample, the patch embedding, each MSDeformAttn
    layer's value_proj / sampling_offsets / attention_weights / output_proj,
    and the rest of the pixel decoder."""
    import re

    if name.startswith("backbone."):
        parts = name.split(".")
        if parts[1] == "patch_embed":
            return "swin.patch_embed"
        if parts[1].startswith("norm"):
            return f"swin.res{int(parts[1][4:]) + 2}.norms"
        stage = f"swin.res{int(parts[2]) + 2}"
        if parts[3] == "downsample":
            return f"{stage}.downsample"
        role = parts[5]
        if role == "attn":  # qkv, proj, relative_position_bias_table
            return f"{stage}.{'rel_pos_table' if parts[6].startswith('relative') else parts[6]}"
        return f"{stage}.{'mlp' if role == 'mlp' else 'norms'}"
    if name.startswith("sem_seg_head.pixel_decoder."):
        m = re.match(r"sem_seg_head\.pixel_decoder\.transformer\.encoder\.layers\.(\d+)"
                     r"\.self_attn\.(\w+)\.", name)
        return f"msda{m.group(1)}.{m.group(2)}" if m else "pixel_decoder.rest"
    return None


def _trunk_parts(name: str, grad):
    """A parameter's gradient under its trunk group, the decoder's as one."""
    return [(trunk_group(name) or "decoder", grad)]


# Limits of the unfrozen kernel-vs-plain step at the seeded initial weights:
# about twice the largest reading of sound runs at seeds 0, 1 and 2 on an
# H100 80GB HBM3 at 700 W (PERF.md: relative error 0.195 and cosine 0.9843 in
# msda0.sampling_offsets and the loss 1.7e-3 apart at seed 1; 0.050-0.070 at
# seeds 0 and 2). Against the same step in f32 through the plain versions,
# each group of the kernel path may be at most UNFROZEN_F32_RATIO_LIMIT times
# as far off as the plain bf16 path: 1 + twice the largest excess read (1.81,
# seed 1, where the decoder's bf16 outputs sit 4-7x further from f32 than at
# seeds 0 and 2 in every path, the plain one included, and swapping any one of
# four kernels for its plain version brings every group back to 0.72-1.09).
UNFROZEN_REL_ERR_LIMIT, UNFROZEN_COSINE_LIMIT = 0.39, 0.969
UNFROZEN_LOSS_REL_ERR_LIMIT = 0.0034
UNFROZEN_F32_RATIO_LIMIT = 2.6


def unfrozen_within_limits(cmp) -> bool:
    return all(v["rel_err"] <= UNFROZEN_REL_ERR_LIMIT and v["cosine"] >= UNFROZEN_COSINE_LIMIT
               for v in cmp.values())


def unfrozen_train_path(seed: int):
    import torch

    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.proposal import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.ops import ms_deform_attn as msda

    cfg = unfrozen_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model, OptimizerConfig(freeze_keys=()), device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 2)
    batches = [synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE)
               for _ in range(UNFROZEN_STEPS)]

    # kernel path against plain versions at the seeded initial weights (a
    # point every run reproduces: the steps below update with atomics in no
    # fixed order), first batch, same noise and matching indices
    batch = batches[0]
    t = loss_fn.device_batch(batch)
    noise = loss_fn.draw_noise(batch, trainer.generator)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)

    def loss_and_grads(lf=loss_fn, m=model):
        m.zero_grad(set_to_none=True)
        total, _ = lf(batch, noise)
        total.backward()
        torch.cuda.synchronize()
        grads = {}
        for n, p in m.named_parameters():
            grads[n] = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        m.zero_grad(set_to_none=True)
        return total.item(), grads

    loss_k, grads_k = loss_and_grads()
    counts = launch_counts()
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    # the same step in f32 through the plain versions: the witness of how far
    # bf16 alone moves each group, in the kernel path and in the plain one
    cfg32 = f32_config(cfg)
    model32 = MaskFormerSegmenter(cfg32.segmenter, device="cuda", seed=seed).train()
    model32.load_state_dict(model.state_dict())
    with plain_versions():
        loss_32, grads_32 = loss_and_grads(make_loss_fn(cfg32, model32, device="cuda"), model32)
    del model32
    if launch_counts() != counts:
        fail("the plain-version unfrozen train step launched a kernel")
    cmp = compare_grads(grads_k, grads_p, _trunk_parts)
    plain_32 = compare_grads(grads_p, grads_32, _trunk_parts)
    ratios = f32_distance_ratios(compare_grads(grads_k, grads_32, _trunk_parts), plain_32)
    del grads_k
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    # the check's own control: the deformable sampling's VJP with
    # d(locations) = 0 must fail the sampling-offset groups
    real = msda.msda_folded
    msda.msda_folded = lambda v, shapes, loc, a: real(v, shapes, loc.detach(), a)
    try:
        _, grads_f = loss_and_grads()
    finally:
        msda.msda_folded = real
    planted = compare_grads(grads_f, grads_p, _trunk_parts)
    planted_ratios = f32_distance_ratios(compare_grads(grads_f, grads_32, _trunk_parts),
                                         plain_32)
    del grads_f, grads_p, grads_32
    offsets = {g: v for g, v in planted.items() if g.endswith(".sampling_offsets")}
    ok = (loss_rel <= UNFROZEN_LOSS_REL_ERR_LIMIT and unfrozen_within_limits(cmp)
          and max(ratios.values()) <= UNFROZEN_F32_RATIO_LIMIT)
    # the fault must fail each sampling-offset group on both witnesses
    planted_rejected = len(offsets) == cfg.segmenter.pixel_decoder.transformer_layers and all(
        not unfrozen_within_limits({g: v}) and planted_ratios[g] > UNFROZEN_F32_RATIO_LIMIT
        for g, v in offsets.items())
    emit({"phase": "kernels_vs_plain_unfrozen_train_step",
          "tolerance": f"total_loss within {UNFROZEN_LOSS_REL_ERR_LIMIT}; per trunk group and "
                       f"the decoder, gradient |g_kernel - g_plain| / |g_plain| <= "
                       f"{UNFROZEN_REL_ERR_LIMIT} and cosine >= {UNFROZEN_COSINE_LIMIT}, and "
                       f"|g_kernel - g_f32| <= {UNFROZEN_F32_RATIO_LIMIT} x |g_plain - g_f32|",
          "total_loss_kernel": loss_k, "total_loss_plain": loss_p, "total_loss_f32": loss_32,
          "total_loss_rel_err": loss_rel, "groups": cmp,
          "largest_rel_err": max(v["rel_err"] for v in cmp.values()),
          "smallest_cosine": min(v["cosine"] for v in cmp.values()),
          "plain_vs_f32": plain_32, "f32_distance_ratio": ratios,
          "largest_f32_distance_ratio": max(ratios.values()),
          "planted_dloc_zero_sampling_offsets": offsets,
          "planted_dloc_zero_f32_distance_ratio": {g: planted_ratios[g] for g in offsets},
          "planted_fault_rejected": planted_rejected, "ok": ok})
    if not ok:
        fail("unfrozen kernel train step disagrees with the plain-version train step")
    if not planted_rejected:
        fail("the unfrozen check passed a deformable sampling with d(locations) = 0")

    # the path: UNFROZEN_STEPS train steps through the entry point
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    latencies, steps = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"unfrozen train step {i}: non-finite metrics {m}")
    for name, per in PER_UNFROZEN_STEP.items():
        if launches[name] != per * UNFROZEN_STEPS:
            fail(f"{name}: {launches[name]} launches in the unfrozen train path, expected "
                 f"{per} x {UNFROZEN_STEPS}")
    moved = {}
    for n, p in model.named_parameters():
        group = trunk_group(n)
        if group is not None:
            moved[group] = moved.get(group, False) or not torch.equal(p.detach(), before[n])
    still = sorted(g for g, m in moved.items() if not m)
    if still:
        fail(f"trunk groups left unchanged by the unfrozen steps: {still}")
    emit({"phase": "unfrozen_train_path", "config": "Swin-L (fused_proj)/MSDeformAttn/9-layer "
          "decoder, bf16, trunk unfrozen, drop_path 0.3, 12544 grid points", "image_size": IMAGE_SIZE, "batch_size": BATCH_SIZE,
          "steps": UNFROZEN_STEPS, "step_latency_s": [round(x, 5) for x in latencies],
          "max_memory_allocated_bytes": int(peak), "launches": launches,
          "launches_per_step": PER_UNFROZEN_STEP,
          "total_loss_per_step": [m["total_loss"] for m in steps],
          "grad_norm_per_step": [m["grad_norm"] for m in steps],
          "trunk_groups_moved": f"{len(moved)}/{len(moved)}"})
    return launches


# --------------------------------------------------------------- phase 9


CLI_CODES = ("n01440764", "n01443537")
CLI_IMAGES_PER_CLASS, CLI_PARTS = 4, 4
CLI_TRAIN_STEPS, CLI_RESUME_STEPS, CLI_BATCH, CLI_BATCH_MEMORY = 4, 6, 2, 8
CLI_KEYS = ("steps", "images_per_sec", "images_per_sec_steady", "first_batch_s", "total_s",
            "loader_wait_s", "step_s", "checkpoint_s", "max_memory_allocated_bytes")


def object_image(rng, ci: int, height: int, width: int):
    """One synthetic ImageNet image: noise with a box of class ``ci``'s
    colour. Returns (pixels, (y0, y1), xs): the box spans rows y0:y1 and
    columns xs[0]:xs[-1], its CLI_PARTS parts the strips xs[k]:xs[k + 1]."""
    img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    y0, x0 = rng.integers(0, height // 4), rng.integers(0, width // 4)
    y1, x1 = rng.integers(3 * height // 4, height), rng.integers(3 * width // 4, width)
    img[y0:y1, x0:x1] = [60 + 80 * ci, 160, 220 - 60 * ci]
    return img, (y0, y1), np.linspace(x0, x1, CLI_PARTS + 1).astype(int)


def strip_rles(height: int, width: int, rows, xs) -> list:
    """The RLEs of the parts ``object_image`` describes."""
    from partdistillation_torch.utils import rle

    parts = []
    for k in range(CLI_PARTS):
        m = np.zeros((height, width), bool)
        m[rows[0]:rows[1], xs[k]:xs[k + 1]] = True
        parts.append(rle.encode(m))
    return parts


def cli_dataset(tmp: str, seed: int = 0, height: int = 375, width: int = 500) -> list:
    """A synthetic ImageNet split under ``tmp`` for the stage-3 CLIs: JPEGs
    of ImageNet's typical 500 x 375 with one coloured object each, a
    stage-2b proposal store (the port's ``ShardWriter``, RLE part masks
    tiling the object) under ``tmp/pseudo_labels/proposals_dcrf`` and a
    PartImageNet-style json with polygon parts over the same images.
    Returns the ``--set`` overrides that point the CLIs at them."""
    import os

    from PIL import Image

    from partdistillation_torch.data.pseudo_store import ShardWriter

    rng = np.random.default_rng(seed)
    root = os.path.join(tmp, "imagenet")
    images, annotations = [], []
    with ShardWriter(os.path.join(tmp, "pseudo_labels", "proposals_dcrf"), 0, 1) as writer:
        for ci, code in enumerate(CLI_CODES):
            os.makedirs(os.path.join(root, code))
            for j in range(CLI_IMAGES_PER_CLASS):
                img, (y0, y1), xs = object_image(rng, ci, height, width)
                Image.fromarray(img).save(os.path.join(root, code, f"{code}_{j}.JPEG"))
                for k in range(CLI_PARTS):
                    annotations.append({
                        "id": len(annotations), "image_id": ci * CLI_IMAGES_PER_CLASS + j,
                        "category_id": k, "segmentation": [[
                            float(xs[k]), float(y0), float(xs[k + 1]), float(y0),
                            float(xs[k + 1]), float(y1), float(xs[k]), float(y1)]]})
                writer.write({"image_id": f"{code}_{j}",
                              "part_masks": strip_rles(height, width, (y0, y1), xs),
                              "object_ratio": float((y1 - y0) * (xs[-1] - xs[0]))
                              / (height * width)})
                images.append({"id": ci * CLI_IMAGES_PER_CLASS + j,
                               "file_name": f"{code}/{code}_{j}.JPEG",
                               "height": height, "width": width})
    with open(os.path.join(root, "labels.txt"), "w") as f:
        f.write("n01440764 tench\nn01443537 goldfish\n")
    part_json = os.path.join(tmp, "part_imagenet.json")
    with open(part_json, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": k, "name": f"part{k}"} for k in range(CLI_PARTS)]}, f)
    return [f"data.imagenet_root={root}", f"data.part_imagenet_json={part_json}",
            f"data.part_imagenet_images={root}", f"paths.root={tmp}/pseudo_labels",
            f"checkpoint_dir={tmp}/ckpt", f"seed={seed}"]


def run_cli(argv) -> dict:
    """``partdistillation_torch.run.main(argv)`` in this process; its
    printed lines are echoed to stderr, its last JSON line returned."""
    import io

    from partdistillation_torch import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.main(argv)
    lines = out.getvalue().strip().splitlines()
    print("\n".join(lines), file=sys.stderr, flush=True)
    return json.loads([line for line in lines if line.startswith("{")][-1])


def oob_probe():
    """Wraps ``MSDeformAttn.forward``: each call records its layer's
    out-of-band fraction (``msda_band_oob_fraction`` at the layer's band
    settings) under the layer's order of first call. Returns (records,
    restore)."""
    import torch

    from partdistillation_torch.models.attention import MSDeformAttn
    from partdistillation_torch.ops.ms_deform_attn import msda_band_oob_fraction

    real, records, order = MSDeformAttn.forward, {}, {}

    def forward(self, query, reference_points, value_flatten, spatial_shapes):
        with torch.no_grad():
            loc, weights = self.sampling(query, reference_points, spatial_shapes)
            oob = msda_band_oob_fraction(spatial_shapes, loc, weights, self.band_radius,
                                         self.band_tile_queries, self.band_tile_x)
        layer = order.setdefault(id(self), len(order))
        records.setdefault(layer, []).append(float(oob))
        return real(self, query, reference_points, value_flatten, spatial_shapes)

    MSDeformAttn.forward = forward
    return records, lambda: setattr(MSDeformAttn, "forward", real)


def cli_path(seed: int, tmp: str, refs: dict):
    """Phase 9: the stage-3 CLIs as a user runs them, in this process, at the
    full-size default (Swin-L, banded radius-4 sampling, bf16, trunk frozen,
    12544 points) over ``cli_dataset``: ``train-proposal`` for
    CLI_TRAIN_STEPS steps at B = CLI_BATCH, resumed to CLI_RESUME_STEPS, then
    ``eval-proposal --trainer-checkpoint`` on the PartImageNet-style set;
    then one step at B = CLI_BATCH_MEMORY for its peak memory. Launches are
    counted per run and must be exact. The data and checkpoints stay in
    ``tmp`` for phases 11-13; ``refs["phase9"]`` gets what phase 13 repeats."""
    import os

    import torch

    from partdistillation_torch import run
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    per_step = dict(PER_TRAIN_STEP)
    paths, banded = {}, {}
    t0 = time.perf_counter()
    ov = cli_dataset(tmp, seed)
    data_s = time.perf_counter() - t0
    common = ["--set", *ov, f"data.batch_size={CLI_BATCH}", "checkpoint_every=2",
              "log_every=1"]
    runs = {}
    for name, steps, before in (("train", CLI_TRAIN_STEPS, 0),
                                ("resume", CLI_RESUME_STEPS, CLI_TRAIN_STEPS)):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = run_cli(["train-proposal", *common, f"max_iters={steps}"])
        launches, taken = launch_counts(), steps - before
        if res["steps"] != steps:
            fail(f"train-proposal ({name}) ended at step {res['steps']}, not {steps}")
        for kernel, per in per_step.items():
            if launches[kernel] != per * taken:
                fail(f"cli {name}: {kernel} launched {launches[kernel]} times, expected "
                     f"{per} x {taken}")
        if banded_launches() != launches["msda_folded"]:
            fail(f"cli {name}: {banded_launches()} of {launches['msda_folded']} sampling "
                 "launches banded")
        runs[name] = dict(res, launches=launches, banded_launches=banded_launches(),
                          max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        paths["cli_train"] = {k: paths.get("cli_train", {}).get(k, 0) + v
                              for k, v in launches.items()}
        banded["cli_train"] = banded.get("cli_train", 0) + banded_launches()
    ckpt = os.path.join(tmp, "ckpt", "proposal")
    saved = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt"))
    logs = os.path.join(tmp, "ckpt", "logs", "train-proposal", "metrics.jsonl")
    with open(logs) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in logged]
    if [r["step"] for r in logged] != list(range(1, CLI_RESUME_STEPS + 1)) \
            or not all(np.isfinite(losses)):
        fail(f"metrics.jsonl steps / losses: {[(r['step'], r['total_loss']) for r in logged]}")

    # the trunk of every checkpoint equals the seeded initial weights bit
    # for bit; every decoder parameter has moved by the last
    seg = run._segmenter_cfg(False, num_classes=1, num_queries=200, freeze_trunk=True)
    model = MaskFormerSegmenter(seg, device="cuda", seed=seed)
    init = model.state_dict()
    trunk = [k for k in init if k.startswith(TRUNK)]
    head = [n for n, _ in model.named_parameters() if not n.startswith(TRUNK)]
    for f in saved:
        state = torch.load(os.path.join(ckpt, f), map_location="cuda",
                           weights_only=True)["model"]
        changed = [k for k in trunk if not torch.equal(state[k], init[k])]
        if changed:
            fail(f"{f}: frozen trunk tensors changed: {changed[:5]}")
    moved = [k for k in head if not torch.equal(state[k], init[k])]
    del model, init, state

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    records, restore = oob_probe()
    try:
        ev = run_cli(["eval-proposal", "--trainer-checkpoint", ckpt, *common])
    finally:
        restore()
    eval_launches = launch_counts()
    n_items = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    forwards = -(-n_items // CLI_BATCH)
    for kernel, per in PER_FORWARD.items():
        if eval_launches[kernel] != per * forwards:
            fail(f"cli eval: {kernel} launched {eval_launches[kernel]} times, expected "
                 f"{per} x {forwards}")
    if banded_launches() != eval_launches["msda_folded"]:
        fail("cli eval: unbanded sampling launches")
    ar = {k: v for k, v in ev.items() if k.startswith("AR@")}
    if len(ar) != 5 or not all(0.0 <= v <= 100.0 for v in ar.values()) \
            or ev["# instances"] != n_items:
        fail(f"eval-proposal: {ev}")
    oob = [max(records[layer]) for layer in sorted(records)]
    if len(oob) != seg.pixel_decoder.transformer_layers or not all(np.isfinite(oob)):
        fail(f"out-of-band fractions per encoder layer: {oob}")
    paths["cli_eval"] = eval_launches
    banded["cli_eval"] = banded_launches()
    eval_peak = torch.cuda.max_memory_allocated()
    refs["phase9"] = {"ov": ov, "eval": {**ar, "# instances": ev["# instances"]},
                      "train": runs["train"], "eval_peak": eval_peak}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big = run_cli(["train-proposal", "--set", *ov, f"data.batch_size={CLI_BATCH_MEMORY}",
                   f"checkpoint_dir={tmp}/ckpt_b{CLI_BATCH_MEMORY}", "max_iters=1",
                   "log_every=1"])
    big_peak = torch.cuda.max_memory_allocated()
    train, resume = runs["train"], runs["resume"]
    emit({"phase": "cli_path", "config": "train-proposal / eval-proposal, full-size default: "
          "Swin-L/MSDeformAttn banded radius 4/9-layer decoder, bf16, trunk frozen, 12544 "
          "grid points", "image_decode": "PIL", "data_setup_s": round(data_s, 3),
          "train": {k: train[k] for k in CLI_KEYS if k in train},
          "resume": {k: resume[k] for k in CLI_KEYS if k in resume},
          "launches_per_step": per_step, "banded_launches_per_step": per_step["msda_folded"],
          "total_loss_per_step": losses, "checkpoints": saved,
          "trunk_unchanged_in": saved, "decoder_params_moved": f"{len(moved)}/{len(head)}",
          "eval": {**ar, "# instances": ev["# instances"], "forwards": forwards,
                   "max_memory_allocated_bytes": eval_peak},
          "oob_fraction_per_encoder_layer": oob,
          "batch_8_one_step": {"step_s": big["step_s"], "first_batch_s": big["first_batch_s"],
                               "loader_wait_s": big["loader_wait_s"],
                               "max_memory_allocated_bytes": big_peak}})
    if len(moved) != len(head):
        fail(f"decoder parameters left unchanged: {sorted(set(head) - set(moved))[:5]}")
    return paths, banded


# --------------------------------------------------------------- phase 10


DISTILL_OBJECTS, DISTILL_PARTS, DISTILL_GT_PARTS = 22000, 8, 40
# the synthetic stage-4 store's object class per image (cli_dataset's order):
# spread over the head's 22,000 classes, two images of class 4711, one of the
# last class, whose columns end just before the no-object column
DISTILL_OBJECT_CLASS = (21999, 4711, 4711, 0, 12345, 7, 17000, 999)
DISTILL_VOCAB = {CLI_CODES[0]: 4711, CLI_CODES[1]: 21999}  # eval classes, via data.vocab_map
DISTILL_GRAD_IMAGES = (1, 2, 0)  # the one-batch check: classes 4711, 4711, 21999
DISTILL_METRICS = ("C-mIoU", "A-mIoU", "C-mACC", "A-mACC", "C-mIoPred", "A-mIoPred")
HEAD_WEIGHT = "sem_seg_head.predictor.part_class_embed.weight"
# Limits of the head's live-column gradient, kernel vs plain: about twice the
# largest readings of sound runs on an H100 80GB HBM3 at 700 W at seeds 0-2,
# each run twice by tools/torch_head_grad_seeds.py (rel. error 0.00131 /
# 0.00306 / 0.00108, cosine 0.9999992 / 0.9999952 / 0.9999995; the two runs
# of a seed agree to 1e-8). Phase 7's decoder limits (0.30, 0.978) would let
# a fault of a few percent through.
HEAD_GRAD_REL_ERR_LIMIT, HEAD_GRAD_COSINE_LIMIT = 0.0062, 0.99999


def stage4_store(tmp: str, seed: int = 0):
    """A stage-4 store over ``cli_dataset``'s images under
    ``tmp/pseudo_labels/part_masks_with_class`` (its proposals as part
    masks, cluster labels in [0, 8), scores, DISTILL_OBJECT_CLASS) and the
    vocabulary file giving the eval set's synsets ids of the head. Returns
    the ``--set`` overrides and the train items of the store."""
    import os

    from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter

    rng = np.random.default_rng(seed + 10)
    labels = os.path.join(tmp, "pseudo_labels")
    proposals = PseudoLabelStore(os.path.join(labels, "proposals_dcrf"))
    store = os.path.join(labels, "part_masks_with_class")
    items = []
    with ShardWriter(store, 0, 1) as writer:
        for i, (code, j) in enumerate((c, j) for c in CLI_CODES
                                      for j in range(CLI_IMAGES_PER_CLASS)):
            image_id = f"{code}_{j}"
            parts = proposals.get(image_id)["part_masks"]
            writer.write({"image_id": image_id, "part_masks": parts,
                          "part_labels": [int(x) for x in rng.integers(0, DISTILL_PARTS,
                                                                       len(parts))],
                          "part_scores": [float(x) for x in rng.uniform(0.3, 1.0, len(parts))],
                          "object_class": DISTILL_OBJECT_CLASS[i]})
            items.append({"image_id": image_id, "part_label_store": store,
                          "file_name": os.path.join(tmp, "imagenet", code, f"{image_id}.JPEG")})
    vocab = os.path.join(tmp, "vocab.json")
    with open(vocab, "w") as f:
        json.dump(DISTILL_VOCAB, f)
    return [f"data.vocab_map={vocab}"], items


def distill_config():
    """The stage-5 CLI's train configuration at full width."""
    from partdistillation_torch import run
    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig
    from partdistillation_torch.models.meta_arch.part_distillation import (
        PartDistillationConfig)

    seg = run._segmenter_cfg(False, num_classes=DISTILL_PARTS, num_queries=200,
                             num_object_classes=DISTILL_OBJECTS, num_parts=DISTILL_PARTS,
                             freeze_trunk=True)
    return PartDistillationConfig(
        segmenter=seg, num_parts=DISTILL_PARTS,
        criterion=CriterionConfig(num_classes=DISTILL_PARTS, num_points=12544,
                                  matcher=MatcherConfig(num_points=12544)))


def head_gradient_check(seed: int, items) -> dict:
    """One batch of three stage-4 images (two of one class, one of the last
    class) through the stage-5 loss at the seeded initial weights: the part
    head's gradient must be nonzero in exactly the batch's live columns (its
    classes' and the no-object column), and the loss and that gradient must
    agree with the same step through the plain versions (same weights,
    batch, noise and matching): the loss within phase 7's limit, the
    gradient within HEAD_GRAD_REL_ERR_LIMIT and HEAD_GRAD_COSINE_LIMIT."""
    import torch

    from partdistillation_torch.data.mappers import PartDistillationTrainMapper
    from partdistillation_torch.models.meta_arch.part_distillation import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = distill_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed).train()
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    mapper = PartDistillationTrainMapper(image_size=IMAGE_SIZE, capacity=MASK_SLOTS, seed=seed)
    examples = [mapper(items[i]) for i in DISTILL_GRAD_IMAGES]
    batch = {k: np.stack([e[k] for e in examples]) for k in ("image", "masks", "labels",
                                                              "valid", "gt_object_class")}
    g = torch.Generator(device=loss_fn.device)
    g.manual_seed(seed)
    noise = loss_fn.draw_noise(batch, g)
    t = loss_fn.device_batch(batch)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)
    head = model.get_parameter(HEAD_WEIGHT)

    def loss_and_grad():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batch, noise)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), head.grad.detach().clone()

    loss_k, grad_k = loss_and_grad()
    with plain_versions():
        loss_p, grad_p = loss_and_grad()
    cols = model.sem_seg_head.predictor.live_columns(torch.as_tensor(batch["gt_object_class"]))
    live = torch.zeros(head.shape[0], dtype=torch.bool, device=head.device)
    live[cols.flatten()] = True
    nonzero = grad_k.abs().sum(dim=1) > 0
    a, b = grad_k[live].flatten(), grad_p[live].flatten()
    out = {"classes": batch["gt_object_class"].tolist(), "live_columns": int(live.sum()),
           "nonzero_rows": int(nonzero.sum()),
           "nonzero_rows_outside_live": int((nonzero & ~live).sum()),
           "live_rows_zero": int((live & ~nonzero).sum()),
           "total_loss_kernel": loss_k, "total_loss_plain": loss_p,
           "total_loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "head_grad_rel_err": ((a - b).norm() / b.norm()).item(),
           "head_grad_cosine": (a @ b / (a.norm() * b.norm())).item()}
    out["ok"] = (out["nonzero_rows_outside_live"] == 0 and out["live_rows_zero"] == 0
                 and out["total_loss_rel_err"] <= LOSS_REL_ERR_LIMIT
                 and out["head_grad_rel_err"] <= HEAD_GRAD_REL_ERR_LIMIT
                 and out["head_grad_cosine"] >= HEAD_GRAD_COSINE_LIMIT)
    del model, loss_fn
    return out


def distill_path(seed: int, tmp_root: str, refs: dict):
    """Phase 10: the stage-5 CLIs as a user runs them, in this process, at
    the full-size default (Swin-L, banded radius-4 sampling, bf16, trunk
    frozen, 12544 points, the 22,000 x 8 + 1 column part head) over
    ``cli_dataset``'s images and a ``stage4_store``: ``train-distillation``
    for CLI_TRAIN_STEPS steps at B = CLI_BATCH, ``distill-save
    --trainer-checkpoint``, ``distill-eval --trainer-checkpoint
    --num-gt-parts 40`` on the PartImageNet-style set, one step at
    B = CLI_BATCH_MEMORY; then the head's gradient on one batch. Launches
    are counted per run and must be exact. The data and checkpoints stay in
    ``tmp_root/distill`` for phase 13; ``refs["phase10"]`` gets what phase
    13 repeats."""
    import os

    import torch

    from partdistillation_torch.data.pseudo_store import PseudoLabelStore
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter
    from partdistillation_torch.utils import rle

    paths, banded = {}, {}

    def counted(name, argv, per_run):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = run_cli(argv)
        launches = launch_counts()
        for kernel, n in per_run.items():
            if launches[kernel] != n:
                fail(f"{name}: {kernel} launched {launches[kernel]} times, expected {n}")
        if banded_launches() != launches["msda_folded"]:
            fail(f"{name}: {banded_launches()} of {launches['msda_folded']} sampling "
                 "launches banded")
        paths[name], banded[name] = launches, banded_launches()
        return dict(res, max_memory_allocated_bytes=torch.cuda.max_memory_allocated())

    head = ["--num-object-classes", str(DISTILL_OBJECTS), "--num-parts", str(DISTILL_PARTS)]
    n_items = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    forwards = -(-n_items // CLI_BATCH)
    tmp = os.path.join(tmp_root, "distill")
    os.makedirs(tmp)
    t0 = time.perf_counter()
    ov = cli_dataset(tmp, seed)
    extra, items = stage4_store(tmp, seed)
    ov += extra
    data_s = time.perf_counter() - t0
    common = ["--set", *ov, f"data.batch_size={CLI_BATCH}", "checkpoint_every=2",
              "log_every=1"]
    train = counted("distill_train",
                    ["train-distillation", *head, *common, f"max_iters={CLI_TRAIN_STEPS}"],
                    {k: v * CLI_TRAIN_STEPS for k, v in PER_TRAIN_STEP.items()})
    if train["steps"] != CLI_TRAIN_STEPS:
        fail(f"train-distillation ended at step {train['steps']}")
    ckpt = os.path.join(tmp, "ckpt", "part_distillation")
    saved = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt"))
    with open(os.path.join(tmp, "ckpt", "logs", "train-distillation",
                           "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in logged]
    if [r["step"] for r in logged] != list(range(1, CLI_TRAIN_STEPS + 1)) \
            or not all(np.isfinite(losses)):
        fail(f"metrics.jsonl steps / losses: {[(r['step'], r['total_loss']) for r in logged]}")

    # the trunk of every checkpoint equals the seeded initial weights bit
    # for bit; every decoder parameter, the part head included, has moved
    seg = distill_config().segmenter
    model = MaskFormerSegmenter(seg, device="cuda", seed=seed)
    init = model.state_dict()
    trunk = [k for k in init if k.startswith(TRUNK)]
    decoder = [n for n, _ in model.named_parameters() if not n.startswith(TRUNK)]
    for f in saved:
        state = torch.load(os.path.join(ckpt, f), map_location=init[trunk[0]].device,
                           weights_only=True)
        changed = [k for k in trunk if not torch.equal(state["model"][k], init[k])]
        if changed:
            fail(f"{f}: frozen trunk tensors changed: {changed[:5]}")
    moved = [k for k in decoder if not torch.equal(state["model"][k], init[k])]
    head_shape = tuple(state["model"][HEAD_WEIGHT].shape)
    head_moments = [tuple(s["exp_avg"].shape) for s in state["optimizer"]["adam"]["state"]
                    .values() if tuple(s["exp_avg"].shape) == head_shape]
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, saved[-1]))
    del model, init, state
    if head_shape != (DISTILL_OBJECTS * DISTILL_PARTS + 1, seg.decoder.hidden_dim) \
            or len(head_moments) != 1:
        fail(f"checkpoint head {head_shape}, its AdamW moments {head_moments}")
    if len(moved) != len(decoder):
        fail(f"decoder parameters left unchanged: {sorted(set(decoder) - set(moved))[:5]}")

    save = counted("distill_save", ["distill-save", "--trainer-checkpoint", ckpt, *head,
                                    *common],
                   {k: v * forwards for k, v in PER_FORWARD.items()})
    records = list(PseudoLabelStore(os.path.join(tmp, "pseudo_labels",
                                                 "part_distillation_predictions")))
    # an image whose parts all lose every pixel (random weights) is not saved
    if not 0 < save["saved"] == len(records) <= n_items:
        fail(f"distill-save saved {save['saved']}, the store holds {len(records)}")
    for r in records:
        masks = [rle.decode(m) for m in r["part_masks"]]
        if not masks or any(m.shape != (IMAGE_SIZE, IMAGE_SIZE) for m in masks) \
                or not all(0 <= x < DISTILL_PARTS for x in r["part_labels"]) \
                or not all(0.0 <= x <= 1.0 for x in r["part_scores"]) \
                or r["object_class"] not in DISTILL_OBJECT_CLASS:
            fail(f"predictions record {r['image_id']}: labels {r['part_labels']}, "
                 f"scores {r['part_scores']}, class {r['object_class']}")

    ev = counted("distill_eval", ["distill-eval", "--trainer-checkpoint", ckpt, *head,
                                  "--num-gt-parts", str(DISTILL_GT_PARTS), *common],
                 {k: v * 2 * forwards for k, v in PER_FORWARD.items()})  # match + eval
    mapping = np.load(os.path.join(tmp, "ckpt", "distill_mapping.npz"))["mapping"]
    metrics = {k: ev.get(k) for k in DISTILL_METRICS}
    if mapping.shape != (DISTILL_OBJECTS, DISTILL_PARTS) or not all(
            v is not None and (np.isnan(v) or 0.0 <= v <= 100.0) for v in metrics.values()):
        fail(f"distill-eval: mapping {mapping.shape}, metrics {metrics}")

    torch.cuda.empty_cache()
    big = counted("distill_train_b8",
                  ["train-distillation", *head, "--set", *ov,
                   f"data.batch_size={CLI_BATCH_MEMORY}",
                   f"checkpoint_dir={tmp}/ckpt_b{CLI_BATCH_MEMORY}", "max_iters=1",
                   "log_every=1"], PER_TRAIN_STEP)
    torch.cuda.empty_cache()
    grad = head_gradient_check(seed, items)
    writes = len([s for s in range(1, CLI_TRAIN_STEPS + 1) if s % 2 == 0])
    emit({"phase": "distill_path", "config": "train-distillation / distill-save / "
          "distill-eval, full-size default: Swin-L/MSDeformAttn banded radius 4/9-layer "
          "decoder, bf16, trunk frozen, 12544 grid points, part head 22000 x 8 + 1 columns",
          "data_setup_s": round(data_s, 3),
          "train": {k: train[k] for k in CLI_KEYS if k in train},
          "checkpoint_s_per_write": round(train["checkpoint_s"] / writes, 3),
          "checkpoint_bytes": ckpt_bytes, "launches_per_step": PER_TRAIN_STEP,
          "total_loss_per_step": losses, "checkpoints": saved, "trunk_unchanged_in": saved,
          "decoder_params_moved": f"{len(moved)}/{len(decoder)}",
          "head": {"shape": list(head_shape), "adamw_moments": len(head_moments)},
          "save": {k: save[k] for k in ("saved", "images_per_sec", "images_per_sec_steady",
                                        "first_batch_s", "total_s",
                                        "max_memory_allocated_bytes") if k in save},
          "eval": {**metrics, "mapping_shape": list(mapping.shape),
                   "forwards": 2 * forwards, "num_gt_parts": DISTILL_GT_PARTS,
                   "max_memory_allocated_bytes": ev["max_memory_allocated_bytes"]},
          "batch_8_one_step": {"step_s": big["step_s"], "first_batch_s": big["first_batch_s"],
                               "loader_wait_s": big["loader_wait_s"],
                               "max_memory_allocated_bytes": big["max_memory_allocated_bytes"]},
          "head_gradient": grad})
    if not grad["ok"]:
        fail(f"stage-5 head gradient check: {grad}")
    del paths["distill_train_b8"], banded["distill_train_b8"]
    refs["phase10"] = {"tmp": tmp, "ov": ov, "head": head, "eval": metrics, "train": train}
    return paths, banded


# --------------------------------------------------------------- phase 11


RANK_OBJECTS, RANK_CLUSTERS, RANK_FEATURES, PROPOSE_CLUSTERS = 22000, 8, 256, 4
RANK_CLASSES = tuple(sorted(DISTILL_VOCAB.values()))  # the classes of phase 9's images
# launches per propose forward: the Swin-L backbone alone (its 32 LayerNorms,
# 24 MLP halves and 24 window attentions); rank's forward is PER_FORWARD's
PER_PROPOSE_FORWARD = {name: 0 for name in PER_FORWARD}
PER_PROPOSE_FORWARD.update(layer_norm=32, fused_ln_mlp=24, fused_window_attention=24)
# rank clusters a class with more than k features, and phase 9's weights
# keep 0.5-0.9 an image: rank's run adds this many images of CLI_CODES[0]
RANK_EXTRA_IMAGES = 40
# the card's Lloyd fit against the CPU's at the bank's chunk (64 classes x
# 4096 rows x 256, k = 8, 30 iterations) and at stage 2's (2 images x 6400
# rows x 1152, k = 4), from the same seeding; limits: labels on >= 99.9 % of
# the valid rows, centroids within 5e-7 (over seeds 0-2 the sound fit reads
# at most 1.34e-7, the fit with TF32 products at least 1.71e-6). The fit runs
# in full f32 whatever the process's TF32 flags say (``utils.precision``):
# the TF32 fault rounds the points and the initial centroids to TF32's 10
# mantissa bits before the fit, which is what TF32 products did to them
KMEANS_SHAPES = {"rank_chunk": (64, 4096, 256, RANK_CLUSTERS),
                 "propose_batch": (CLI_BATCH, (IMAGE_SIZE // 8) ** 2, 1152, PROPOSE_CLUSTERS)}
KMEANS_ITERS, KMEANS_LABEL_AGREEMENT, KMEANS_CENTROID_LIMIT = 30, 0.999, 5e-7
KMEANS_FAULTS = ("mask_ignored", "tf32_inputs")


def tf32_round(x):
    """f32 values rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as the tensor cores read an f32 operand under TF32."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def kmeans_inputs(seed: int, b: int, n: int, d: int, k: int):
    """b point sets of n rows (unit-norm blobs around 3k centres, as the
    decoder's normalised features) with ragged valid prefixes of 3k..n rows;
    the padded rows hold other blobs, which a mask ignored would pull in.
    Returns (x, mask, the seeding's uniforms), on the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed)
    centres = torch.randn((b, 3 * k, d), generator=g)
    pick = torch.randint(0, 3 * k, (b, n), generator=g)
    x = centres.gather(1, pick[..., None].expand(b, n, d)) + 0.3 * torch.randn((b, n, d),
                                                                               generator=g)
    x = x / x.norm(dim=-1, keepdim=True)
    counts = torch.randint(3 * k, n + 1, (b,), generator=g)
    counts[0] = n
    mask = torch.arange(n)[None] < counts[:, None]
    x = torch.where(mask[..., None], x, -x)  # padded rows: the mirrored blobs
    return x, mask, torch.rand((b, k), generator=g)


def kmeans_card_vs_cpu(seed: int, b: int, n: int, d: int, k: int, fault: str = ""):
    """The Lloyd fit on the card against the CPU's from the same seeding:
    the share of valid rows whose labels agree and the largest centroid
    difference. ``fault`` (one of KMEANS_FAULTS) plants one on the card:
    the mask ignored in the update, or the inputs rounded to TF32."""
    import torch

    from partdistillation_torch.ops.kmeans import kmeans_pp_init, lloyd

    assert fault in ("", *KMEANS_FAULTS), fault
    x, mask, u = kmeans_inputs(seed, b, n, d, k)
    init = kmeans_pp_init(x, mask, u)
    want_c, want_l = lloyd(x, mask, init, KMEANS_ITERS)
    update_mask = torch.ones_like(mask) if fault == "mask_ignored" else mask
    x_card, init_card = x.cuda(), init.cuda()
    if fault == "tf32_inputs":
        x_card, init_card = tf32_round(x_card), tf32_round(init_card)
    got_c, got_l = lloyd(x_card, update_mask.cuda(), init_card, KMEANS_ITERS)
    agree = (got_l.cpu() == want_l)[mask].float().mean().item()
    diff = (got_c.cpu() - want_c).abs().max().item()
    return {"label_agreement": agree, "centroid_max_abs_diff": diff,
            "ok": agree >= KMEANS_LABEL_AGREEMENT and diff <= KMEANS_CENTROID_LIMIT}


def bank_card_vs_cpu(seed: int) -> dict:
    """``ClusteringModule.evaluate()`` on the card against the CPU's over one
    reservoir state: 64 classes spread over the 22,000 holding ragged counts
    of 4096 x 256 features (``kmeans_inputs``), the rest none. The clustered
    classes' centroids within the Lloyd fit's limit, the others bit for bit;
    the card's evaluate() by the host clock."""
    from partdistillation_torch.evaluation.clustering import ClusteringModule

    b, n, d, k = KMEANS_SHAPES["rank_chunk"]
    x, mask, _ = kmeans_inputs(seed, b, n, d, k)
    classes = np.linspace(0, RANK_OBJECTS - 1, b).astype(np.int64)
    banks, seconds = {}, {}
    for device in ("cuda", "cpu"):
        module = ClusteringModule(RANK_OBJECTS, d, k, device=device)
        module.process({"feats": x.numpy(), "valid": mask.numpy()}, classes)
        t0 = time.perf_counter()
        banks[device] = module.evaluate()
        seconds[device] = time.perf_counter() - t0
    diff = float(np.abs(banks["cuda"][classes] - banks["cpu"][classes]).max())
    few = np.ones(RANK_OBJECTS, bool)
    few[classes] = False
    same_few = bool(np.array_equal(banks["cuda"][few], banks["cpu"][few]))
    return {"classes": b, "centroid_max_abs_diff": diff, "few_sample_rows_equal": same_few,
            "evaluate_s": seconds, "ok": diff <= KMEANS_CENTROID_LIMIT and same_few}


def kmeans_timing(seed: int, b: int, n: int, d: int, k: int) -> dict:
    """The seeding and the Lloyd fit on the card at one shape, per point set
    (medians of five reads), beside the bound of the Lloyd fit: x read twice
    an iteration (distances, sums) over the memory rate, or its 4 n d k f32
    operations an iteration over the f32 rate, whichever is larger."""
    from partdistillation_torch.ops.kmeans import kmeans_pp_init, lloyd
    from partdistillation_torch.utils.timing import PEAK_F32_FLOPS, bound, steady

    x, mask, u = (t.cuda() for t in kmeans_inputs(seed, b, n, d, k))
    init = kmeans_pp_init(x, mask, u)
    fit = steady("", lambda: lloyd(x, mask, init, KMEANS_ITERS))
    seeding = steady("", lambda: kmeans_pp_init(x, mask, u))
    bound_ms, bound_by = bound(2 * KMEANS_ITERS * n * d * 4, 4 * KMEANS_ITERS * n * d * k,
                               PEAK_F32_FLOPS)
    return {"shape": [b, n, d, k], "iters": KMEANS_ITERS,
            "lloyd_ms_per_set": fit["ms"] / b,
            "lloyd_ms_per_set_range": [t / b for t in fit["ms_range"]],
            "seeding_ms_per_set": seeding["ms"] / b,
            "bound_ms_per_set": bound_ms, "bound_by": bound_by}


def rank_store(tmp: str, seed: int) -> str:
    """RANK_EXTRA_IMAGES more images of CLI_CODES[0] in ``cli_dataset``'s
    split under ``tmp``, and a stage-2b store of every image of the split
    under ``tmp/rank_labels/proposals_dcrf``. Returns that labels root."""
    import os

    from PIL import Image

    from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter

    rng = np.random.default_rng([seed, 11])
    code, height, width = CLI_CODES[0], 375, 500
    labels = os.path.join(tmp, "rank_labels")
    with ShardWriter(os.path.join(labels, "proposals_dcrf"), 0, 1) as writer:
        for r in PseudoLabelStore(os.path.join(tmp, "pseudo_labels", "proposals_dcrf")):
            writer.write(r)
        for j in range(CLI_IMAGES_PER_CLASS, CLI_IMAGES_PER_CLASS + RANK_EXTRA_IMAGES):
            img, rows, xs = object_image(rng, 0, height, width)
            Image.fromarray(img).save(os.path.join(tmp, "imagenet", code, f"{code}_{j}.JPEG"))
            writer.write({"image_id": f"{code}_{j}",
                          "part_masks": strip_rles(height, width, rows, xs),
                          "object_ratio": float((rows[1] - rows[0]) * (xs[-1] - xs[0]))
                          / (height * width)})
    return labels


def stage1_store(tmp: str) -> list:
    """A stage-1 store over ``cli_dataset``'s images under
    ``tmp/pseudo_labels/object_labels``: each image's object mask is the
    union of its stage-2b proposals. Returns the object masks by image id."""
    import os

    from partdistillation_torch.data.pseudo_store import PseudoLabelStore, ShardWriter
    from partdistillation_torch.utils import rle

    labels = os.path.join(tmp, "pseudo_labels")
    objects = {}
    with ShardWriter(os.path.join(labels, "object_labels"), 0, 1) as writer:
        for r in PseudoLabelStore(os.path.join(labels, "proposals_dcrf")):
            union = np.any([rle.decode(m).astype(bool) for m in r["part_masks"]], axis=0)
            writer.write({"image_id": r["image_id"], "object_masks": [rle.encode(union)],
                          "object_scores": [1.0]})
            objects[r["image_id"]] = union
    return objects


def counted_run(paths: dict, banded: dict, name: str, argv, per_run: dict, fn=None) -> dict:
    """``run_cli(argv)`` (or ``fn()``) with every kernel's launches counted
    from 0: each must equal ``per_run``'s, every sampling launch banded. The
    counts add into ``paths`` and ``banded`` under the name before its
    first ':'. Returns the result with the run's peak device memory."""
    import torch

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_cli(argv) if fn is None else fn()
    launches = launch_counts()
    for kernel, n in per_run.items():
        if launches[kernel] != n:
            fail(f"{name}: {kernel} launched {launches[kernel]} times, expected {n}")
    if banded_launches() != launches["msda_folded"]:
        fail(f"{name}: {banded_launches()} of {launches['msda_folded']} sampling "
             "launches banded")
    key = name.split(":")[0]
    for kernel, n in launches.items():
        paths.setdefault(key, {}).setdefault(kernel, 0)
        paths[key][kernel] += n
    banded[key] = banded.get(key, 0) + banded_launches()
    return dict(res, max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def kmeans_path(seed: int, tmp: str, refs: dict):
    """Phase 11: the k-means stages as a user runs them, in this process, at
    the full-size default over phase 9's ``cli_dataset`` in ``tmp``: stage 2
    (``propose`` on a stage-1 store of each image's proposal union, Swin-L
    bf16, B = CLI_BATCH, k = 4, then ``eval-pixel-grouping``) and stage 4
    (``rank --phases cluster,save`` from phase 9's stage-3 checkpoint into a
    22,000-class bank, phase 10's vocabulary, over phase 9's images and
    ``rank_store``'s, so that a class is clustered; then ``--phases
    match,eval``). Launches are counted per run and must be exact; then the
    card's Lloyd fit against the CPU's, the planted faults, and the k-means
    times. ``refs["phase11"]`` gets what phase 13 repeats."""
    import os

    from partdistillation_torch.data.datasets.imagenet import (
        load_imagenet, load_imagenet_with_proposals, load_imagenet_with_segmentation)
    from partdistillation_torch.data.mappers import (
        PartDistillationTrainMapper, ProposalGenerationMapper, ProposalTrainMapper)
    from partdistillation_torch.data.pseudo_store import PseudoLabelStore, store_complete
    from partdistillation_torch.utils import rle

    paths, banded = {}, {}
    n_items = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    forwards = -(-n_items // CLI_BATCH)
    counted = functools.partial(counted_run, paths, banded)

    root = os.path.join(tmp, "imagenet")
    labels = os.path.join(tmp, "pseudo_labels")
    vocab = os.path.join(tmp, "vocab.json")
    with open(vocab, "w") as f:
        json.dump(DISTILL_VOCAB, f)
    ov = [f"data.imagenet_root={root}", f"data.part_imagenet_json={tmp}/part_imagenet.json",
          f"data.part_imagenet_images={root}", f"paths.root={labels}",
          f"checkpoint_dir={tmp}/ckpt", f"seed={seed}", f"data.vocab_map={vocab}",
          f"data.batch_size={CLI_BATCH}"]
    stage3 = ["--trainer-checkpoint", os.path.join(tmp, "ckpt", "proposal")]

    # stage 2: propose, its store, eval-pixel-grouping
    t0 = time.perf_counter()
    stage1_store(tmp)
    data_s = time.perf_counter() - t0
    propose = counted("propose", ["propose", *stage3, "--set", *ov],
                      {k: v * forwards for k, v in PER_PROPOSE_FORWARD.items()})
    store = os.path.join(labels, "proposal_generation")
    records = {r["image_id"]: r for r in PseudoLabelStore(store)}
    if not 0 < propose["saved"] == len(records) <= n_items or not store_complete(store):
        fail(f"propose saved {propose['saved']}, the store holds {len(records)}")
    mapper = ProposalGenerationMapper(image_size=IMAGE_SIZE)
    items = {it["image_id"]: it for it in load_imagenet(
        root, object_mask_store=os.path.join(labels, "object_labels"), vocab_map=vocab)}
    parts_per_record = []
    for image_id, r in records.items():
        obj = mapper(items[image_id])["object_mask"]
        masks = np.stack([rle.decode(m).astype(bool) for m in r["part_masks"]])
        parts_per_record.append(len(masks))
        if not 1 <= len(masks) <= PROPOSE_CLUSTERS or masks.sum(0).max() > 1 \
                or not np.array_equal(masks.any(0), obj) \
                or abs(r["object_ratio"] - obj.mean()) > 1e-6:
            fail(f"stage-2 record {image_id}: {len(masks)} parts, overlap "
                 f"{masks.sum(0).max()}, union = object {np.array_equal(masks.any(0), obj)}, "
                 f"ratio {r['object_ratio']} vs {obj.mean()}")
    train_items = load_imagenet_with_proposals(list(items.values()), store)
    example = ProposalTrainMapper(image_size=IMAGE_SIZE, capacity=MASK_SLOTS,
                                  seed=seed)(train_items[0])
    if example is None or not example["valid"].any():
        fail("the stage-3 mapper read no part from the stage-2 store")
    grouping = counted("propose:eval", ["eval-pixel-grouping", *stage3, "--set", *ov],
                       {k: v * forwards for k, v in PER_PROPOSE_FORWARD.items()})
    ar = {k: v for k, v in grouping.items() if k.startswith("AR@")}
    if len(ar) != 4 or not all(0.0 <= v <= 100.0 for v in ar.values()):
        fail(f"eval-pixel-grouping: {grouping}")

    # stage 4: rank cluster,save into the 22,000-class bank over phase 9's
    # images and RANK_EXTRA_IMAGES more of CLI_CODES[0], then match,eval
    objects = ["--num-object-classes", str(RANK_OBJECTS)]
    rank_ov = [*ov, f"paths.root={rank_store(tmp, seed)}"]
    rank_items = n_items + RANK_EXTRA_IMAGES
    rank = counted("rank", ["rank", *stage3, *objects, "--set", *rank_ov],
                   {k: v * 2 * -(-rank_items // CLI_BATCH)  # cluster + save
                    for k, v in PER_FORWARD.items()})
    bank = np.load(os.path.join(tmp, "ckpt", "rank_centroids.npz"))["centroids"]
    n_clustered = rank["cluster"]["kmeans_classes"]
    if bank.shape != (RANK_OBJECTS, RANK_CLUSTERS, RANK_FEATURES) or not np.isfinite(bank).all() \
            or not 1 <= n_clustered <= len(RANK_CLASSES):
        fail(f"rank bank {bank.shape}, finite {np.isfinite(bank).all()}, "
             f"{n_clustered} classes clustered")
    # CLI_CODES[0]'s class, which holds the added images, is clustered first;
    # the others hold RandomState(0)'s draw in class order, and the clustered
    # ones means of features normalised in bf16 (norms within 2^-8 of 1)
    clustered = [DISTILL_VOCAB[code] for code in CLI_CODES][:n_clustered]
    few = np.ones(RANK_OBJECTS, bool)
    few[clustered] = False
    draw = np.random.RandomState(0).randn(RANK_OBJECTS - n_clustered, RANK_CLUSTERS,
                                          RANK_FEATURES).astype(np.float32)
    if not np.array_equal(bank[few], draw):
        fail(f"the classes but {clustered} do not hold RandomState(0)'s draw")
    del draw
    centroid_norm = float(np.linalg.norm(bank[clustered], axis=-1).max())
    if centroid_norm > 1.0 + 2.0 ** -6:
        fail(f"class {clustered}'s centroids reach norm {centroid_norm}: not means of "
             "normalised features")
    stage4 = os.path.join(tmp, "rank_labels", "part_masks_with_class")
    saved = list(PseudoLabelStore(stage4))
    if not 0 < rank["save"]["saved"] == len(saved) <= rank_items:
        fail(f"rank saved {rank['save']['saved']}, the store holds {len(saved)}")
    for r in saved:
        masks = np.stack([rle.decode(m).astype(bool) for m in r["part_masks"]])
        if masks.shape[1:] != (IMAGE_SIZE, IMAGE_SIZE) or masks.sum(0).max() > 1 \
                or not all(0 <= x < RANK_CLUSTERS for x in r["part_labels"]) \
                or not all(0.0 <= x <= 1.0 for x in r["part_scores"]) \
                or r["object_class"] not in RANK_CLASSES:
            fail(f"stage-4 record {r['image_id']}: labels {r['part_labels']}, scores "
                 f"{r['part_scores']}, class {r['object_class']}")
    joined = load_imagenet_with_segmentation(list(items.values()), stage4)
    example = PartDistillationTrainMapper(image_size=IMAGE_SIZE, capacity=MASK_SLOTS,
                                          seed=seed)(joined[0])
    if example is None or int(example["gt_object_class"]) not in RANK_CLASSES:
        fail("the stage-5 mapper did not read the stage-4 store")
    ev = counted("rank:eval", ["rank", *stage3, *objects, "--phases", "match,eval",
                               "--num-gt-parts", str(DISTILL_GT_PARTS), "--set", *rank_ov],
                 {k: v * 2 * forwards for k, v in PER_FORWARD.items()})  # match + eval
    mapping = np.load(os.path.join(tmp, "ckpt", "rank_mapping.npz"))["mapping"]
    metrics = {k: ev["eval"].get(k) for k in DISTILL_METRICS}
    if mapping.shape != (RANK_OBJECTS, RANK_CLUSTERS) or mapping.min() < 0 \
            or mapping.max() >= DISTILL_GT_PARTS or not all(
                v is not None and (np.isnan(v) or 0.0 <= v <= 100.0) for v in metrics.values()):
        fail(f"rank match,eval: mapping {mapping.shape}, metrics {metrics}")
    refs["phase11"] = {"argv": [*stage3, *objects, "--num-gt-parts", str(DISTILL_GT_PARTS),
                                "--set", *rank_ov], "eval": ev["eval"],
                       "rank_items": rank_items}

    # the card's Lloyd fit against the CPU's (at the bank's chunk through
    # ClusteringModule.evaluate()), then the planted faults
    fits = {"propose_batch": kmeans_card_vs_cpu(seed, *KMEANS_SHAPES["propose_batch"]),
            "bank_evaluate": bank_card_vs_cpu(seed)}
    planted = {fault: kmeans_card_vs_cpu(seed, *KMEANS_SHAPES["rank_chunk"], fault=fault)
               for fault in KMEANS_FAULTS}
    timing = {name: kmeans_timing(seed, *shape) for name, shape in KMEANS_SHAPES.items()}
    keep = ("saved", "images_per_sec", "images_per_sec_steady", "first_batch_s", "total_s",
            "max_memory_allocated_bytes")
    emit({"phase": "kmeans_path", "config": "propose / eval-pixel-grouping: Swin-L bf16, "
          "k = 4; rank: Swin-L/MSDeformAttn banded radius 4/9-layer decoder bf16, 200 "
          "queries, 22000 x 8 x 256 bank", "data_setup_s": round(data_s, 3),
          "propose": {k: propose[k] for k in keep if k in propose},
          "propose_parts_per_record": parts_per_record,
          "eval_pixel_grouping": {k: grouping[k] for k in (*ar, *keep) if k in grouping},
          "launches_per_propose_forward": PER_PROPOSE_FORWARD,
          "launches_per_rank_forward": PER_FORWARD, "forwards_per_phase": forwards,
          "rank": {"cluster": rank["cluster"], "save": rank["save"],
                   "max_memory_allocated_bytes": rank["max_memory_allocated_bytes"],
                   "bank_shape": list(bank.shape), "clustered_classes": clustered,
                   "clustered_centroid_norm_max": centroid_norm},
          "rank_eval": {"match": ev["match"], "eval": ev["eval"],
                        "mapping_shape": list(mapping.shape),
                        "max_memory_allocated_bytes": ev["max_memory_allocated_bytes"]},
          "kmeans_card_vs_cpu": fits, "kmeans_planted_faults": planted,
          "kmeans_limits": {"label_agreement": KMEANS_LABEL_AGREEMENT,
                            "centroid_max_abs_diff": KMEANS_CENTROID_LIMIT},
          "kmeans_timing": timing})
    if not all(f["ok"] for f in fits.values()):
        fail(f"k-means on the card disagrees with the CPU: {fits}")
    if any(f["ok"] for f in planted.values()):
        fail(f"a planted k-means fault passed: {planted}")
    return paths, banded


# --------------------------------------------------------------- phase 12


FRONT_PROPOSALS, FRONT_TOPK = 100, 10  # detect's full-size defaults (--proposals, --topk)
CLIP_CLASSES, CLIP_TOKENS = 22000, 77  # the text tower embeds a 22,000-class vocabulary
CLIP_CHECK_MASKS = 16  # masks an image scored on the card and on the CPU
# the CLIP scorer on the card (the vision tower in bf16) against the same
# function in f32 on the CPU, over 2 x CLIP_CHECK_MASKS masks. Read on an
# H100 80GB HBM3 at 700 W at seeds 0-2 by tools/torch_front_seeds.py (16
# boxes an image): ids all equal, probabilities within 0.00050-0.00135; with
# the crop boxes transposed 62.5-78.1 % of ids equal and probabilities
# 0.0144-0.067 apart; in phase 12 at seed 0 (8 of detect's masks and 8
# boxes an image) 0.00227 sound, 0.0167 transposed. The f32 text tower's
# embeddings read 2.2-2.9e-7 (64 prompts).
CLIP_ID_AGREEMENT, CLIP_PROB_LIMIT, CLIP_TEXT_LIMIT = 0.9, 0.005, 1e-6
# the dCRF on the card against the CPU at 640^2, f32: Q's max |diff| and the
# share of equal refined-mask pixels. Read as above: Q within 0.00063-0.0056
# (logits of a few thousand, whose f32 ulp is ~5e-4, move a probability by up
# to a quarter of their error), refined pixels all equal; with the colour
# term dropped Q 1.0 apart and 99.10-99.19 % of the pixels equal.
DCRF_Q_LIMIT, DCRF_MASK_AGREEMENT = 0.012, 0.9999


@contextlib.contextmanager
def tf32_flags_on():
    """Both TF32 flags on, as a user's process may have them (cuDNN's is on
    by default): the f32 stages must pin full f32 themselves."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def clip_prompts(seed: int, n: int) -> np.ndarray:
    """(n, CLIP_TOKENS) token ids of synthetic prompts as CLIP's tokenizer
    lays them out: start token, 2-14 word ids, end-of-text, zero padding."""
    rng = np.random.default_rng([seed, 12])
    ids = np.zeros((n, CLIP_TOKENS), np.int64)
    lengths = rng.integers(2, 15, n)
    ids[:, 0] = 49406
    words = rng.integers(1, 49406, (n, CLIP_TOKENS))
    for i, m in enumerate(lengths):
        ids[i, 1:m + 1] = words[i, :m]
        ids[i, m + 1] = 49407
    return ids


def clip_towers(seed: int, device):
    """The CLIP ViT-B/32 towers at full width from seeded weights: the vision
    tower in bf16 (as the device scorer runs it), the text tower in f32."""
    import torch

    from partdistillation_torch.models.clip_text import CLIPTextTower
    from partdistillation_torch.models.clip_vit import CLIPVisionTower, CLIPVisionTowerConfig

    vision = CLIPVisionTower(CLIPVisionTowerConfig(dtype=torch.bfloat16), device=device,
                             seed=seed)
    return vision, CLIPTextTower(device=device, seed=seed + 1)


def text_card_vs_cpu(text, prompts, card_emb) -> float:
    """The f32 text tower's normalised embeddings of ``prompts`` on the CPU
    (the card tower's weights) against ``card_emb``: the max |diff|."""
    from partdistillation_torch.models.clip_text import CLIPTextTower
    from partdistillation_torch.models.meta_arch.labeling import clip_text_classifier_device

    cpu = CLIPTextTower(text.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in text.state_dict().items()})
    return float(np.abs(clip_text_classifier_device(cpu, prompts) - card_emb).max())


def clip_card_vs_cpu(vision, text_emb, images, masks) -> dict:
    """The device scorer on the card (``vision``, bf16) against the same
    function in f32 on the CPU (the same weights), and with each of
    its planted faults on the card ("boxes_transposed": the masks handed
    over transposed, so the crop boxes' x and y swap): the share of masks
    whose class ids agree and the largest probability difference. images
    (B, H, W, 3) uint8, masks (B, K, H, W) bool, numpy."""
    import dataclasses

    import torch

    from partdistillation_torch.models.clip_vit import CLIPVisionTower
    from partdistillation_torch.models.meta_arch.labeling import clip_region_scorer_device

    cpu = CLIPVisionTower(dataclasses.replace(vision.cfg, dtype=torch.float32), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in vision.state_dict().items()})
    want_ids, want_p = clip_region_scorer_device(cpu, text_emb).batched(images, masks)
    card = clip_region_scorer_device(vision, text_emb)
    out = {}
    for fault, card_masks in (("", masks), ("boxes_transposed", masks.transpose(0, 1, 3, 2))):
        got_ids, got_p = card.batched(images, card_masks)
        agree = float((got_ids == want_ids).mean())
        diff = float(np.abs(got_p - want_p).max())
        out[fault or "sound"] = {"id_agreement": agree, "prob_max_abs_diff": diff,
                                 "ok": agree >= CLIP_ID_AGREEMENT and diff <= CLIP_PROB_LIMIT}
    return out


def dcrf_card_vs_cpu(images, masks, valid) -> dict:
    """``dense_crf`` at the CLI's parameters on the card against the CPU, in
    f32, and with its planted faults on the card ("colour_dropped":
    the bilateral kernel without its colour term): Q's largest difference
    and the share of the refined masks' pixels (``argmax == 1 + t`` where
    valid) that are equal. images (B, H, W, 3) [0, 255], masks (B, T, H, W)
    bool, valid (B, T), numpy."""
    import dataclasses

    import torch

    from partdistillation_torch.ops.dense_crf import DenseCRFParams, dense_crf, unary_from_masks

    params = DenseCRFParams()
    image = torch.as_tensor(np.asarray(images, np.float32))
    unary = unary_from_masks(torch.as_tensor(masks), torch.as_tensor(valid), params.gt_prob)
    labels = 1 + torch.arange(masks.shape[1])[:, None, None]
    slots = torch.as_tensor(valid)[:, :, None, None]

    def refined(q):
        return (q.argmax(-1)[:, None] == labels) & slots

    want = dense_crf(image, unary, params)
    out = {}
    for fault, card in (("", params), ("colour_dropped",
                                       dataclasses.replace(params, bilateral_srgb=1e9))):
        got = dense_crf(image.cuda(), unary.cuda(), card).cpu()
        diff = float((got - want).abs().max())
        agree = float((refined(got) == refined(want)).float().mean())
        out[fault or "sound"] = {"q_max_abs_diff": diff, "refined_pixel_agreement": agree,
                                 "ok": diff <= DCRF_Q_LIMIT and agree >= DCRF_MASK_AGREEMENT}
    return out


def dcrf_timing(images, masks, valid) -> dict:
    """The dCRF's window setup and one apply (one mean-field iteration's
    bilateral message) on the card at the CLI's parameters (stride 4), per
    image (medians of five reads), beside their bounds: the least bytes over
    the memory rate, the (ky, hl, wl, kx) f32 window weights written once
    (setup) or read once (apply) with the image or the values and message."""
    import torch

    from partdistillation_torch.ops.dense_crf import (DenseCRFParams, _bilateral_conv_apply,
                                                      _bilateral_conv_setup, unary_from_masks)
    from partdistillation_torch.utils.timing import bound, steady

    p = DenseCRFParams()
    image = torch.as_tensor(np.asarray(images, np.float32)).cuda()
    q = torch.softmax(-unary_from_masks(torch.as_tensor(masks), torch.as_tensor(valid),
                                        p.gt_prob).cuda(), dim=-1)
    b, h, w, c = q.shape
    band, geom = _bilateral_conv_setup(image, p.bilateral_sxy, p.bilateral_srgb)
    hl, wl, r = geom[2], geom[3], geom[5]
    weights = (2 * r + 1) ** 2 * hl * wl * 4  # bytes an image
    setup = steady("", lambda: _bilateral_conv_setup(image, p.bilateral_sxy, p.bilateral_srgb))
    apply = steady("", lambda: _bilateral_conv_apply(q, band, geom))
    return {"batch": b, "stride": geom[4], "window_weights_bytes_per_image": weights,
            "band_bytes_per_image": band[0].numel() * 4,
            "setup_ms_per_image": setup["ms"] / b,
            "setup_ms_range": [t / b for t in setup["ms_range"]],
            "setup_bound_ms_per_image": bound(weights + h * w * 3 * 4, 0)[0],
            "apply_ms_per_image": apply["ms"] / b,
            "apply_ms_range": [t / b for t in apply["ms_range"]],
            "apply_bound_ms_per_image": bound(weights + 2 * h * w * c * 4, 0)[0]}


def front_check_inputs(seed: int, n_masks: int = CLIP_CHECK_MASKS):
    """Two synthetic IMAGE_SIZE^2 images like phase 9's (noise, one coloured
    object), ``n_masks`` boxes each off the diagonal with sides 8 to
    IMAGE_SIZE (the last one empty) for the CLIP scorer, and for the dCRF
    the object's CLI_PARTS strips with edges jagged by up to 6 pixels a row
    (MASK_SLOTS slots, CLI_PARTS valid). Returns (images uint8, boxes,
    (images f32, strips, valid))."""
    rng = np.random.default_rng([seed, 13])
    size = IMAGE_SIZE
    images, boxes, parts = [], [], []
    for ci in range(2):
        img, (y0, y1), xs = object_image(rng, ci, size, size)
        images.append(img)
        m = np.zeros((n_masks, size, size), bool)
        for k in range(n_masks - 1):
            h, w = rng.integers(8, size, 2)
            top, left = rng.integers(0, size - h + 1), rng.integers(0, size - w + 1)
            m[k, top:top + h, left:left + w] = True
        boxes.append(m)
        p = np.zeros((MASK_SLOTS, size, size), bool)
        for k in range(CLI_PARTS):
            for y in range(y0, y1):
                a = xs[k] + (rng.integers(-6, 7) if k else 0)
                b = xs[k + 1] + (rng.integers(-6, 7) if k < CLI_PARTS - 1 else 0)
                p[k, y, a:b] = True
            p[k] &= ~p[:k].any(0)
        parts.append(p)
    valid = np.zeros((2, MASK_SLOTS), bool)
    valid[:, :CLI_PARTS] = True
    images = np.stack(images)
    return images, np.stack(boxes), (images.astype(np.float32), np.stack(parts), valid)


def front_path(seed: int, tmp: str, refs: dict):
    """Phase 12: the front of the pipeline as a user runs it, in this
    process, at the full-size default over phase 9's ``cli_dataset`` and
    stage-3 checkpoint in ``tmp``: ``detect`` (Swin-L bf16, 200 queries, 100
    proposals, top 10, B = CLI_BATCH), ``label`` over a detections store of
    detect's masks, ``eval-detect``, ``propose`` on detect's store, ``dcrf``
    on propose's store once plainly and once with ``--watch`` over a store
    already complete; then ``run_labeling_batched`` with the device CLIP
    scorer (ViT-B/32 bf16, the text tower's embeddings of 22,000 prompts);
    the CLIP scorer and the dCRF on the card against the CPU, with their
    planted faults; the dCRF's setup and apply times. Launches are counted
    per run and must be exact. ``refs["phase12"]`` keeps the CLIP check's
    towers and inputs for phase 15."""
    import os

    import torch

    from partdistillation_torch import run as pcli
    from partdistillation_torch.data.datasets.imagenet import (load_imagenet,
                                                               load_imagenet_with_proposals)
    from partdistillation_torch.data.mappers import (PartRankingMapper,
                                                     ProposalGenerationMapper,
                                                     ProposalTrainMapper)
    from partdistillation_torch.data.pseudo_store import (PseudoLabelStore, ShardWriter,
                                                          store_complete)
    from partdistillation_torch.models.meta_arch.labeling import (
        LabelingConfig, clip_region_scorer_device, clip_text_classifier_device,
        run_labeling_batched)
    from partdistillation_torch.utils import rle

    paths, banded = {}, {}
    counted = functools.partial(counted_run, paths, banded)
    root = os.path.join(tmp, "imagenet")
    labels = os.path.join(tmp, "front_labels")
    vocab = os.path.join(tmp, "vocab.json")
    n_items = len(load_imagenet(root, vocab_map=vocab))  # phase 9's and phase 11's images
    forwards = -(-n_items // CLI_BATCH)
    ov = [f"data.imagenet_root={root}", f"data.part_imagenet_json={tmp}/part_imagenet.json",
          f"data.part_imagenet_images={root}", f"paths.root={labels}",
          f"checkpoint_dir={tmp}/ckpt", f"seed={seed}", f"data.vocab_map={vocab}",
          f"data.batch_size={CLI_BATCH}"]
    stage3 = ["--trainer-checkpoint", os.path.join(tmp, "ckpt", "proposal")]
    no_kernel = {name: 0 for name in PER_FORWARD}

    def records(store):
        return {r["image_id"]: r for r in PseudoLabelStore(store)}

    def check_stage1(store, n_classes):
        got = records(store)
        for image_id, r in got.items():
            masks = [rle.decode(m) for m in r["object_masks"]]
            if not 1 <= len(masks) <= FRONT_TOPK or any(m.shape != (IMAGE_SIZE, IMAGE_SIZE)
                                                         for m in masks) \
                    or not all(0.0 <= x <= 1.0 for x in r["scores"]) \
                    or not all(-1 <= c < n_classes for c in r["pred_classes"]):
                fail(f"stage-1 record {image_id}: {len(masks)} masks, scores {r['scores']}, "
                     f"classes {r['pred_classes']}")
        return got

    # stage 1: detect, its store read by propose's mapper, label, eval-detect
    detect = counted("detect", ["detect", *stage3, "--set", *ov],
                     {k: v * forwards for k, v in PER_FORWARD.items()})
    object_labels = os.path.join(labels, "object_labels")
    stage1 = check_stage1(object_labels, 0)
    if not 0 < detect["saved"] == len(stage1) <= n_items:
        fail(f"detect saved {detect['saved']}, the store holds {len(stage1)}")
    items = load_imagenet(root, object_mask_store=object_labels, vocab_map=vocab)
    example = ProposalGenerationMapper(image_size=IMAGE_SIZE)(items[0])
    if example is None or not example["object_mask"].any():
        fail("the stage-2 mapper read no object mask from detect's store")
    detections = os.path.join(tmp, "front_detections")
    with ShardWriter(detections, 0, 1) as w:
        for i, r in enumerate(stage1.values()):
            w.write({"image_id": r["image_id"], "masks": r["object_masks"],
                     "scores": r["scores"], "class_ids": [i % 2] * len(r["scores"])})
    label_root = os.path.join(tmp, "front_label_cli")
    label = counted("detect:label", ["label", "--detections", detections, "--set", *ov,
                                     f"paths.root={label_root}"], no_kernel)
    labelled = check_stage1(os.path.join(label_root, "object_labels"), 2)
    if not label["saved"] == len(labelled) == len(stage1):
        fail(f"label saved {label['saved']} of {len(stage1)}")
    eval_forwards = -(-len(CLI_CODES) * CLI_IMAGES_PER_CLASS // CLI_BATCH)  # the json's images
    evaluate = counted("detect:eval", ["eval-detect", *stage3, "--set", *ov],
                       {k: v * eval_forwards for k, v in PER_FORWARD.items()})
    ar = {k: v for k, v in evaluate.items() if k.startswith("AR@")}
    if len(ar) != 4 or not all(0.0 <= v <= 100.0 for v in ar.values()):
        fail(f"eval-detect: {evaluate}")

    # stage 2 on detect's store, then stage 2b
    propose = counted("front:propose", ["propose", *stage3, "--set", *ov],
                      {k: v * -(-len(stage1) // CLI_BATCH)
                       for k, v in PER_PROPOSE_FORWARD.items()})
    stage2 = os.path.join(labels, "proposal_generation")
    if not 0 < propose["saved"] == len(records(stage2)) or not store_complete(stage2):
        fail(f"propose on detect's store saved {propose['saved']}")
    # what the chain hands on at phase 9's weights: the area of detect's best
    # mask, propose's parts a record and their area (shares of the image)
    chain = {"detect_top_mask_area": float(np.mean([
                 rle.decode(r["object_masks"][0]).mean() for r in stage1.values()])),
             "propose_parts_per_record": float(np.mean([
                 len(r["part_masks"]) for r in records(stage2).values()])),
             "propose_part_area": float(np.mean([
                 rle.decode(m).mean() for r in records(stage2).values()
                 for m in r["part_masks"]]))}
    dcrf = counted("front:dcrf", ["dcrf", "--set", *ov], no_kernel)
    refined = records(os.path.join(labels, "proposals_dcrf"))
    if not 0 < dcrf["saved"] == len(refined) <= propose["saved"]:
        fail(f"dcrf saved {dcrf['saved']} of {propose['saved']}")
    for image_id, r in refined.items():
        masks = np.stack([rle.decode(m).astype(bool) for m in r["part_masks"]])
        if masks.shape[1:] != (IMAGE_SIZE, IMAGE_SIZE) or masks.sum(0).max() > 1 \
                or not masks.any((1, 2)).all() \
                or abs(r["object_ratio"] - masks.any(0).mean()) > 1e-12:
            fail(f"dcrf record {image_id}: overlap {masks.sum(0).max()}, ratio "
                 f"{r['object_ratio']} vs {masks.any(0).mean()}")
    joined = load_imagenet_with_proposals(items, os.path.join(labels, "proposals_dcrf"))
    ranked = PartRankingMapper(image_size=IMAGE_SIZE, capacity=MASK_SLOTS)(joined[0])
    trained = ProposalTrainMapper(image_size=IMAGE_SIZE, capacity=MASK_SLOTS, seed=seed)(joined[0])
    if ranked is None or trained is None or not trained["valid"].any():
        fail("the stage-3 and stage-4 mappers did not read the dcrf store")
    watch_root = os.path.join(tmp, "front_watch")
    os.makedirs(watch_root)
    os.symlink(stage2, os.path.join(watch_root, "proposal_generation"))
    watch = counted("front:dcrf_watch", ["dcrf", "--watch", "--watch-interval", "0.5",
                                         "--set", *ov, f"paths.root={watch_root}"], no_kernel)
    if watch["saved"] != dcrf["saved"] or records(
            os.path.join(watch_root, "proposals_dcrf")) != refined:
        fail(f"dcrf --watch over a complete store saved {watch['saved']}, not the plain "
             "run's records")

    # stage 1 with the device CLIP scorer: the towers at full width from
    # seeded weights, the text tower's embeddings of CLIP_CLASSES prompts
    vision, text = clip_towers(seed, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prompts = clip_prompts(seed, CLIP_CLASSES)
    text_emb = clip_text_classifier_device(text, prompts)
    text_s = time.perf_counter() - t0
    text_diff = text_card_vs_cpu(text, prompts[:64], text_emb[:64])
    scorer = clip_region_scorer_device(vision, text_emb)
    args = pcli.build_parser().parse_args(["detect", *stage3, "--set", *ov])
    _, detection_fn = pcli._detection_setup(pcli._setup(args), args,
                                            torch.device(args.device), FRONT_PROPOSALS)
    clip_store = os.path.join(tmp, "front_clip", "object_labels")

    def label_with_clip():
        with ShardWriter(clip_store, 0, 1) as w:
            t = time.perf_counter()
            stats = run_labeling_batched(detection_fn, items, w, LabelingConfig(topk=FRONT_TOPK),
                                         region_scorer=scorer, image_size=IMAGE_SIZE,
                                         batch_size=CLI_BATCH, num_workers=4)
            return dict(stats, images_per_sec=len(items) / (time.perf_counter() - t))

    clip = counted("detect:clip", None, {k: v * -(-len(items) // CLI_BATCH)
                                         for k, v in PER_FORWARD.items()}, fn=label_with_clip)
    with_classes = check_stage1(clip_store, CLIP_CLASSES)
    if clip["saved"] != len(with_classes) or not any(
            c >= 0 for r in with_classes.values() for c in r["pred_classes"]):
        fail(f"run_labeling_batched with the CLIP scorer: {clip}")

    # the CLIP scorer and the dCRF, card against CPU, then the faults
    from partdistillation_torch.data.transforms import load_image, resize_image

    images = np.stack([resize_image(load_image(it["file_name"]), (IMAGE_SIZE, IMAGE_SIZE))
                       for it in items[:2]])
    # the detect batch's first masks and as many boxes, which a transposed
    # crop must move (detect's masks at phase 9's weights span most of the
    # image); the dCRF on jagged strips of an object (phase 12's stage-2
    # store at these weights is mostly refined away)
    _, boxes, crf_inputs = front_check_inputs(seed)
    half = CLIP_CHECK_MASKS // 2
    masks = detection_fn(images)["masks"][:, :half].cpu().numpy()
    clip_masks = np.concatenate([masks, boxes[:, :half]], 1)
    clip_check = clip_card_vs_cpu(vision, text_emb, images, clip_masks)
    refs["phase12"] = {"vision": vision, "text_emb": text_emb, "images": images,
                       "masks": clip_masks}
    crf_check = dcrf_card_vs_cpu(*crf_inputs)
    timing = dcrf_timing(*crf_inputs)
    keep = ("saved", "skipped", "empty", "images_per_sec", "images_per_sec_steady",
            "first_batch_s", "total_s", "max_memory_allocated_bytes")
    emit({"phase": "front_path", "config": "detect / eval-detect: Swin-L/MSDeformAttn banded "
          "radius 4/9-layer decoder bf16, 200 queries, 100 proposals, top 10; propose: Swin-L "
          "bf16, k = 4; dcrf: 10 iterations, stride 4, 9 labels, f32; CLIP ViT-B/32 bf16 + "
          "text tower f32 (77 tokens, 22000 prompts); both TF32 flags on",
          "detect": {k: detect[k] for k in keep if k in detect},
          "label": {k: label[k] for k in keep if k in label},
          "eval_detect": {k: evaluate[k] for k in (*ar, *keep) if k in evaluate},
          "propose_on_detect": {k: propose[k] for k in keep if k in propose},
          "dcrf": {k: dcrf[k] for k in keep if k in dcrf},
          "dcrf_watch": {k: watch[k] for k in keep if k in watch}, "chain": chain,
          "detect_with_clip": {k: clip[k] for k in keep if k in clip},
          "clip_text_embeddings_s": round(text_s, 3),
          "clip_text_card_vs_cpu_max_abs_diff": text_diff,
          "launches_per_forward": PER_FORWARD, "detect_forwards": forwards,
          "eval_detect_forwards": eval_forwards,
          "clip_card_vs_cpu": clip_check,
          "clip_limits": {"id_agreement": CLIP_ID_AGREEMENT, "prob_max_abs_diff": CLIP_PROB_LIMIT,
                          "text_max_abs_diff": CLIP_TEXT_LIMIT},
          "dcrf_card_vs_cpu": crf_check,
          "dcrf_limits": {"q_max_abs_diff": DCRF_Q_LIMIT,
                          "refined_pixel_agreement": DCRF_MASK_AGREEMENT},
          "dcrf_timing": timing})
    if text_diff > CLIP_TEXT_LIMIT:
        fail(f"the text tower on the card disagrees with the CPU: {text_diff}")
    if not clip_check["sound"]["ok"] or not crf_check["sound"]["ok"]:
        fail(f"the card disagrees with the CPU: CLIP {clip_check}, dCRF {crf_check}")
    if any(v["ok"] for c in (clip_check, crf_check) for k, v in c.items() if k != "sound"):
        fail(f"a planted fault passed: CLIP {clip_check}, dCRF {crf_check}")
    return paths, banded


# --------------------------------------------------------------- phase 13


DDP_CHECK_TIMEOUT_S, TORCHRUN_CLI_TIMEOUT_S = 600, 600


def torchrun(nproc: int, argv, timeout: int) -> str:
    """``python -m torch.distributed.run --standalone --nproc-per-node
    nproc argv`` in a session of its own (killed whole at ``timeout``);
    fails unless it exits 0. Returns its stdout; its stderr goes to ours."""
    import os
    import signal

    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", *argv], stdout=subprocess.PIPE,
                            stderr=sys.stderr, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"torchrun {argv[0]} did not end within {timeout} s")
    if proc.returncode != 0:
        fail(f"torchrun {argv[0]} exited {proc.returncode}: {out[-2000:]}")
    return out


def torchrun_cli_worker(spec: str, out: str) -> int:
    """The rank of phase 13's world-1 run: joins the NCCL group torchrun
    describes, then runs each command of ``spec`` through
    ``partdistillation_torch.run.main`` with the kernels' launches counted
    from 0 (and both TF32 flags as the phase it repeats had them), and
    writes what each printed last, its launches and its peak device memory
    to ``out``."""
    import torch
    import torch.distributed as dist

    from partdistillation_torch.engine import launch

    if not launch.initialize("cuda"):
        fail("--torchrun-cli runs under torchrun")
    try:
        results = []
        with open(spec) as f:
            commands = json.load(f)
        for name, argv, tf32 in commands:
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with tf32_flags_on() if tf32 else contextlib.nullcontext():
                res = run_cli(argv)
            results.append({"name": name, "result": res, "launches": launch_counts(),
                            "banded_launches": banded_launches(),
                            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                            "backend": dist.get_backend(), "world": dist.get_world_size(),
                            "device": str(torch.cuda.current_device())})
        if launch.is_main_process():
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        launch.teardown()
    return 0


def _logged_losses(ckpt_dir: str, stage: str, steps: int) -> list:
    import os

    with open(os.path.join(ckpt_dir, "logs", stage, "metrics.jsonl")) as f:
        return [json.loads(line)["total_loss"] for line in f][:steps]


def _checkpoint_distance(a: str, b: str) -> dict:
    """Tensors of two checkpoints' models: how many differ, the largest
    difference."""
    import torch

    sa = torch.load(a, map_location="cpu", weights_only=True)["model"]
    sb = torch.load(b, map_location="cpu", weights_only=True)["model"]
    if sa.keys() != sb.keys():
        fail(f"{a} and {b} hold different tensors")
    diff = [float((sa[k].double() - sb[k].double()).abs().max()) if not torch.equal(sa[k], sb[k])
            else 0.0 for k in sa]
    return {"tensors": len(diff), "tensors_differing": sum(d > 0 for d in diff),
            "max_abs_diff": max(diff)}


def _train_against_single(name: str, ddp_dir: str, ref_dir: str, sub: str, stage: str) -> dict:
    """World 1's losses and step-CLI_TRAIN_STEPS checkpoint against the
    single-process run's: bit for bit (the frozen step is deterministic on
    the card)."""
    import os

    ckpt = f"model_{CLI_TRAIN_STEPS:08d}.pt"
    got = _logged_losses(ddp_dir, stage, CLI_TRAIN_STEPS)
    want = _logged_losses(ref_dir, stage, CLI_TRAIN_STEPS)
    dist = _checkpoint_distance(os.path.join(ddp_dir, sub, ckpt), os.path.join(ref_dir, sub, ckpt))
    out = {"losses_world1": got, "losses_single_process": want,
           "checkpoint_vs_single_process": dist}
    if got != want or dist["tensors_differing"]:
        fail(f"{name}: world 1 differs from the single-process run: {out}")
    return out


def multi_gpu_path(seed: int, tmp: str, refs: dict):
    """Phase 13: (a) world 1 through NCCL, ``torchrun --nproc-per-node 1``
    over phases 9-11's data and checkpoints: ``train-proposal`` and
    ``train-distillation`` for CLI_TRAIN_STEPS steps, ``eval-proposal``,
    ``rank`` (all four phases) and ``distill-eval``, with exact launch
    counts, every sampling launch banded, the losses and the checkpoints
    bit for bit the single-process runs' and the metrics phases 9-11's;
    (b) ``tools/torch_ddp_check.py`` under torchrun with two ranks on this
    card through gloo: the data-parallel stage-3 step against one process,
    a planted per-rank mask count that must miss its limits, and one stage-5
    step with the head sharded over the two ranks against the unsharded
    one."""
    import os

    p9, p10, p11 = refs["phase9"], refs["phase10"], refs["phase11"]
    dtmp = p10["tmp"]
    work = os.path.join(tmp, "world1")
    rank_root = os.path.join(work, "rank_labels")
    os.makedirs(rank_root)
    os.symlink(os.path.join(tmp, "rank_labels", "proposals_dcrf"),
               os.path.join(rank_root, "proposals_dcrf"))
    steps = [f"data.batch_size={CLI_BATCH}", "checkpoint_every=2", "log_every=1"]
    stage3 = ["--trainer-checkpoint", os.path.join(tmp, "ckpt", "proposal")]
    distill_ckpt = ["--trainer-checkpoint", os.path.join(dtmp, "ckpt", "part_distillation")]
    n_items = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    forwards = -(-n_items // CLI_BATCH)
    commands = [
        ("train_proposal", ["train-proposal", "--set", *p9["ov"], *steps,
                            f"max_iters={CLI_TRAIN_STEPS}", f"checkpoint_dir={work}/stage3"],
         {k: v * CLI_TRAIN_STEPS for k, v in PER_TRAIN_STEP.items()}),
        ("train_distillation", ["train-distillation", *p10["head"], "--set", *p10["ov"], *steps,
                                f"max_iters={CLI_TRAIN_STEPS}", f"checkpoint_dir={work}/stage5"],
         {k: v * CLI_TRAIN_STEPS for k, v in PER_TRAIN_STEP.items()}),
        ("eval_proposal", ["eval-proposal", *stage3, "--set", *p9["ov"], *steps,
                           f"checkpoint_dir={work}/eval"],
         {k: v * forwards for k, v in PER_FORWARD.items()}),
        ("rank", ["rank", "--phases", "cluster,save,match,eval", *p11["argv"],
                  f"paths.root={rank_root}", f"checkpoint_dir={work}/rank"],
         {k: v * 2 * (-(-p11["rank_items"] // CLI_BATCH) + forwards)
          for k, v in PER_FORWARD.items()}),
        ("distill_eval", ["distill-eval", *distill_ckpt, *p10["head"], "--num-gt-parts",
                          str(DISTILL_GT_PARTS), "--set", *p10["ov"], *steps,
                          f"checkpoint_dir={work}/distill_eval"],
         {k: v * 2 * forwards for k, v in PER_FORWARD.items()}),
    ]
    spec, out = os.path.join(work, "spec.json"), os.path.join(work, "results.json")
    with open(spec, "w") as f:
        # phase 11 (rank) ran with both TF32 flags on
        json.dump([(name, argv, name == "rank") for name, argv, _ in commands], f)
    t0 = time.perf_counter()
    torchrun(1, [__file__, "--torchrun-cli", spec, out], TORCHRUN_CLI_TIMEOUT_S)
    world1_s = time.perf_counter() - t0
    with open(out) as f:
        results = {r["name"]: r for r in json.load(f)}
    paths = {}
    for name, _, per_run in commands:
        r = results[name]
        if (r["backend"], r["world"]) != ("nccl", 1):
            fail(f"world-1 {name} ran on {r['backend']} x {r['world']}")
        for kernel, n in per_run.items():
            if r["launches"][kernel] != n:
                fail(f"world-1 {name}: {kernel} launched {r['launches'][kernel]} times, "
                     f"expected {n}")
        if r["banded_launches"] != r["launches"]["msda_folded"]:
            fail(f"world-1 {name}: {r['banded_launches']} of {r['launches']['msda_folded']} "
                 "sampling launches banded")
        paths[f"world1_{name}"] = r["launches"]

    train3 = _train_against_single("train-proposal", f"{work}/stage3",
                                   os.path.join(tmp, "ckpt"), "proposal", "train-proposal")
    train5 = _train_against_single("train-distillation", f"{work}/stage5",
                                   os.path.join(dtmp, "ckpt"), "part_distillation",
                                   "train-distillation")
    ev = results["eval_proposal"]["result"]
    rank = results["rank"]["result"]
    dev = results["distill_eval"]["result"]
    metrics = {
        "eval_proposal": ({k: ev[k] for k in p9["eval"]}, p9["eval"]),
        "rank_eval": ({k: rank["eval"][k] for k in DISTILL_METRICS},
                      {k: p11["eval"][k] for k in DISTILL_METRICS}),
        "distill_eval": ({k: dev[k] for k in DISTILL_METRICS}, p10["eval"]),
    }
    unequal = {k: v for k, v in metrics.items() if json.dumps(v[0]) != json.dumps(v[1])}
    same_files = {
        name: bool(np.array_equal(np.load(a)[key], np.load(b)[key]))
        for name, a, b, key in (
            ("rank_centroids", f"{work}/rank/rank_centroids.npz",
             os.path.join(tmp, "ckpt", "rank_centroids.npz"), "centroids"),
            ("rank_mapping", f"{work}/rank/rank_mapping.npz",
             os.path.join(tmp, "ckpt", "rank_mapping.npz"), "mapping"),
            ("distill_mapping", f"{work}/distill_eval/distill_mapping.npz",
             os.path.join(dtmp, "ckpt", "distill_mapping.npz"), "mapping"))}
    keys = ("images_per_sec", "images_per_sec_steady", "step_s", "loader_wait_s",
            "first_batch_s")
    beside = {
        name: {"world1_nccl": {**{k: results[name]["result"].get(k) for k in keys},
                               "max_memory_allocated_bytes":
                                   results[name]["max_memory_allocated_bytes"]},
               "single_process": {**{k: ref.get(k) for k in keys},
                                  "max_memory_allocated_bytes":
                                      ref["max_memory_allocated_bytes"]}}
        for name, ref in (("train_proposal", p9["train"]), ("train_distillation", p10["train"]))}

    # (b) two ranks on this card through gloo
    check = os.path.join(work, "ddp_check.jsonl")
    t0 = time.perf_counter()
    torchrun(2, [os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                              "torch_ddp_check.py"), "--seeds", str(seed), "--out", check],
             DDP_CHECK_TIMEOUT_S)
    ddp_s = time.perf_counter() - t0
    with open(check) as f:
        ddp = json.loads(f.readline())
    s3 = ddp["stage3_data_parallel"]
    emit({"phase": "multi_gpu", "world1": {
              "launcher": "python -m torch.distributed.run --standalone --nproc-per-node 1",
              "backend": "nccl", "seconds": round(world1_s, 3),
              "launches_exact": True, "train_proposal": train3, "train_distillation": train5,
              "metrics_equal_phases_9_11": not unequal, "metrics": metrics,
              "files_equal_phases_10_11": same_files, "beside_single_process": beside,
              "max_memory_allocated_bytes": {name: r["max_memory_allocated_bytes"]
                                             for name, r in results.items()}},
          "two_ranks_gloo_one_card": {**ddp, "seconds": round(ddp_s, 3),
                                      "grad_sync_share_of_step": s3["ddp"]["grad_sync_share"]}})
    if unequal:
        fail(f"world-1 metrics differ from phases 9-11: {unequal}")
    if not ddp["ok"]:
        fail(f"the two-rank checks failed: {ddp}")
    return paths


# --------------------------------------------------------------- phase 14


SUP_TRAIN_STEPS, SUP_RESUME_STEPS, SUP_SHORT_STEPS = 4, 6, 2
SUP_CLASSES = 40
SUP_PASCAL_IMAGES = 4  # one object each, and one image of two objects
SUP_CITYSCAPES_IMAGES = 2  # every image holds all five part classes
# the v1 heads (FPN / transformer-FPN pixel decoder, standard decoder): the
# trunk's kernels only
PER_V1_STEP = {**PER_TRAIN_STEP, "fused_masked_attention": 0,
               "fused_masked_attention_bwd": 0, "msda_folded": 0}
# the criterion on the card against the CPU at the supervised step's shapes:
# 10 supervised layers, B = 2, T = 8 targets, 200 queries, 160^2 mask logits
CRIT_LAYERS, CRIT_HW = 10, 160
# Limits of phase 14, about twice the worst sound reading at seeds 0-2 on an
# H100 80GB HBM3 at 700 W (PERF.md; `tools/torch_supervised_seeds.py`). The
# criterion on the card against the CPU, the same f32 logits and points: the
# kept points all equal, the loss 9.1e-8 and the gradients 6.2e-8 apart at
# most (the sign fault: no point equal, the loss 33 % off)
CRIT_SHARE_LIMIT, CRIT_LOSS_REL_ERR_LIMIT, CRIT_GRAD_REL_ERR_LIMIT = 0.999, 2e-7, 1.25e-7
# the supervised train step through the kernels against the plain versions
# (same weights, batch, noise and matching): the loss 8.0e-4 apart at most,
# the groups 0.243 and cosine 0.977 (msda0.sampling_offsets at seed 1), with
# 97.9-99.1 % of the kept points equal
SUP_LOSS_REL_ERR_LIMIT = 0.0016
SUP_REL_ERR_LIMIT, SUP_COSINE_LIMIT = 0.49, 0.954


def eval_sets(tmp: str, seed: int) -> list:
    """A Pascal-Parts set (500 x 375 JPEGs, VOC ``.mat`` annotations through
    ``scipy.io.savemat``: SUP_PASCAL_IMAGES images of one dog or cat with
    head and legs, one image of both) and a Cityscapes-Part set (2048 x 1024
    ``leftImg8bit`` PNGs and panoptic-parts uid TIFFs, 32-bit since the ids
    exceed 16 bits: every image holds a person, rider, car, truck and bus
    with their parts) under ``tmp``. Returns the ``--set`` overrides."""
    import os

    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(seed + 14)
    ann = os.path.join(tmp, "pascal", "Annotations_Part")
    jpg = os.path.join(tmp, "pascal", "JPEGImages")
    os.makedirs(ann)
    os.makedirs(jpg)

    def box(h, w, y0, y1, x0, x1):
        m = np.zeros((h, w), np.uint8)
        m[y0:y1, x0:x1] = 1
        return m

    def animal(cls, y0, y1, x0, x1, h=375, w=500):
        ym = (y0 + y1) // 2
        xm = (x0 + x1) // 2
        return {"class": cls, "mask": box(h, w, y0, y1, x0, x1),
                "parts": [{"part_name": "head", "mask": box(h, w, y0, ym, x0, x1)},
                          {"part_name": "lfleg", "mask": box(h, w, ym, y1, x0, xm)},
                          {"part_name": "rbleg", "mask": box(h, w, ym, y1, xm, x1)}]}

    for i in range(SUP_PASCAL_IMAGES + 1):
        img = rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
        if i < SUP_PASCAL_IMAGES:
            objs = [animal("dog" if i % 2 == 0 else "cat", 40, 330, 60, 440)]
        else:
            objs = [animal("dog", 20, 180, 20, 480), animal("cat", 200, 360, 20, 480)]
        for o in objs:
            img[o["mask"].astype(bool)] = [200, 120, 60] if o["class"] == "dog" else [60, 140, 200]
        Image.fromarray(img).save(os.path.join(jpg, f"2008_{i:06d}.jpg"))
        sio.savemat(os.path.join(ann, f"2008_{i:06d}.mat"), {"anno": {"objects": objs}})

    labels = os.path.join(tmp, "cityscapes", "gtFinePanopticParts", "val", "town")
    images = os.path.join(tmp, "cityscapes", "leftImg8bit", "val", "town")
    os.makedirs(labels)
    os.makedirs(images)
    parts = {24: 4, 25: 4, 26: 5, 27: 5, 28: 5}
    for i in range(SUP_CITYSCAPES_IMAGES):
        stem = f"town_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 256, (1024, 2048, 3), dtype=np.uint8)).save(
            os.path.join(images, f"{stem}_leftImg8bit.png"))
        uids = np.full((1024, 2048), 7, np.int32)  # road
        for j, (sid, n) in enumerate(parts.items()):
            x0 = 40 + 400 * j
            for p in range(n):  # horizontal strips, instance j
                uids[200 + 120 * p:320 + 120 * p, x0:x0 + 360] = (sid * 1000 + j) * 100 + p + 1
        Image.fromarray(uids, mode="I").save(os.path.join(labels,
                                                         f"{stem}_gtFinePanopticParts.tif"))
    return [f"data.pascal_parts_annotations={ann}", f"data.pascal_parts_images={jpg}",
            f"data.cityscapes_part_labels={os.path.dirname(os.path.dirname(labels))}",
            f"data.cityscapes_images={os.path.dirname(os.path.dirname(images))}"]


def supervised_config():
    """``train-supervised``'s full-size model on PartImageNet: the default
    heads at SUP_CLASSES part classes, the trunk unfrozen, the criterion's
    random point mode at ratio 0.75 and 12544 points."""
    from partdistillation_torch import run
    from partdistillation_torch.losses.criterion import CriterionConfig
    from partdistillation_torch.losses.matcher import MatcherConfig
    from partdistillation_torch.models.meta_arch.supervised import SupervisedModelConfig

    seg = run._segmenter_cfg(False, num_classes=SUP_CLASSES, num_queries=200)
    return SupervisedModelConfig(
        segmenter=seg, num_part_classes=SUP_CLASSES, test_topk=200,
        criterion=CriterionConfig(num_classes=SUP_CLASSES, num_points=12544,
                                  importance_sample_ratio=0.75,
                                  matcher=MatcherConfig(num_points=12544)))


@contextlib.contextmanager
def recorded_selections(flip: bool = False):
    """Record the pool indices the criterion's random mode keeps (one
    (B, T, n_imp) tensor a supervised layer). ``flip`` plants a fault: the
    uncertainty's sign flipped, so that the most certain points are kept."""
    from partdistillation_torch.losses import criterion as crit

    real, picks = crit.stable_topk, []

    def topk(scores, k):
        s, idx = real(-scores if flip else scores, k)
        picks.append(idx.detach().cpu())
        return s, idx

    crit.stable_topk = topk
    try:
        yield picks
    finally:
        crit.stable_topk = real


def selection_share(got, want, pool: int) -> float:
    """The share of ``got``'s kept pool points that ``want`` keeps too."""
    import torch

    hits, total = 0.0, 0
    for a, b in zip(got, want):
        kept = torch.zeros((*b.shape[:-1], pool), dtype=torch.bool)
        kept.scatter_(-1, b, True)
        hits += kept.gather(-1, a).float().sum().item()
        total += a.numel()
    return hits / total


def criterion_card_vs_cpu(seed: int):
    """The supervised criterion (random point mode, 12544 points, 41
    classes) on the card against the CPU on the same f32 logits, targets,
    matching and point pools: the share of equal kept points, the total
    loss's and the gradients' relative errors. Returns (the sound card run's
    readings, those with the sign fault planted on the card)."""
    import torch

    from partdistillation_torch.losses.criterion import set_criterion

    cfg = supervised_config().criterion
    g = torch.Generator().manual_seed(seed)
    L, b, t, q = CRIT_LAYERS, BATCH_SIZE, MASK_SLOTS, 200
    src = synthetic_train_batch(np.random.default_rng(seed + 5), b, IMAGE_SIZE)
    targets = {"masks": torch.as_tensor(src["masks"]).float(),
               "valid": torch.as_tensor(src["valid"]),
               "labels": torch.randint(0, SUP_CLASSES, (b, t), generator=g)}
    logits = torch.randn(L, b, q, SUP_CLASSES + 1, generator=g)
    masks = torch.randn(L, b, q, CRIT_HW, CRIT_HW, generator=g) * 4.0
    noise = {"point_pool": torch.rand(L, b, t, cfg.n_pool, 2, generator=g),
             "point_fresh": torch.rand(L, b, t, cfg.num_points - cfg.n_importance, 2,
                                       generator=g)}
    indices = torch.stack([torch.stack([torch.randperm(q, generator=g)[:t] for _ in range(b)])
                           for _ in range(L)])

    def run(device, flip):
        lg = logits.to(device).detach().requires_grad_()
        mk = masks.to(device).detach().requires_grad_()
        outs = [{"pred_logits": lg[i], "pred_masks": mk[i]} for i in range(L)]
        with recorded_selections(flip) as picks:
            total, _ = set_criterion({**outs[0], "aux_outputs": outs[1:]},
                                     {k: v.to(device) for k, v in targets.items()},
                                     {k: v.to(device) for k, v in noise.items()}, cfg,
                                     indices.to(device))
            total.backward()
        return total.item(), mk.grad.cpu(), lg.grad.cpu(), picks

    loss_c, gm_c, gl_c, sel_c = run("cpu", False)

    def against_cpu(flip):
        loss_g, gm_g, gl_g, sel_g = run("cuda", flip)
        out = {"share_equal_points": selection_share(sel_g, sel_c, cfg.n_pool),
               "total_loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
               "mask_grad_rel_err": ((gm_g - gm_c).norm() / gm_c.norm()).item(),
               "class_grad_rel_err": ((gl_g - gl_c).norm() / gl_c.norm()).item()}
        out["ok"] = (out["share_equal_points"] >= CRIT_SHARE_LIMIT
                     and out["total_loss_rel_err"] <= CRIT_LOSS_REL_ERR_LIMIT
                     and max(out["mask_grad_rel_err"], out["class_grad_rel_err"])
                     <= CRIT_GRAD_REL_ERR_LIMIT)
        return out

    return against_cpu(False), against_cpu(True)


def _supervised_parts(name: str, grad):
    """A parameter's gradient under its trunk group, or the decoder's groups
    (the cross-attention by q / k / v / out / norm)."""
    group = trunk_group(name)
    return [(group, grad)] if group is not None else _decoder_parts(name, grad)


def supervised_step_check(seed: int) -> dict:
    """The supervised train step at full width through the kernels against
    the plain versions, at the seeded initial weights, on the same batch,
    noise (the random mode's point pools) and matching: the total loss, the
    per-group gradients, and the share of equal kept points."""
    import torch

    from partdistillation_torch.engine.optim import OptimizerConfig
    from partdistillation_torch.engine.trainer import Trainer
    from partdistillation_torch.models.meta_arch.supervised import make_loss_fn
    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    cfg = supervised_config()
    model = MaskFormerSegmenter(cfg.segmenter, device="cuda", seed=seed)
    loss_fn = make_loss_fn(cfg, model, device="cuda")
    trainer = Trainer(loss_fn, model, OptimizerConfig(), device="cuda", seed=seed)
    rng = np.random.default_rng(seed + 3)
    batch = synthetic_train_batch(rng, BATCH_SIZE, IMAGE_SIZE)
    batch["labels"] = rng.integers(0, SUP_CLASSES, (BATCH_SIZE, MASK_SLOTS))
    t = loss_fn.device_batch(batch)
    noise = loss_fn.draw_noise(batch, trainer.generator)
    with torch.no_grad():
        noise["indices"] = loss_fn.match(loss_fn.forward(t, noise), t, noise)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        with recorded_selections() as picks:
            total, _ = loss_fn(batch, noise)
            total.backward()
        torch.cuda.synchronize()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return total.item(), grads, picks

    reset_launches()
    loss_k, grads_k, sel_k = loss_and_grads()
    counts = launch_counts()
    with plain_versions():
        loss_p, grads_p, sel_p = loss_and_grads()
    if launch_counts() != counts:
        fail("the plain-version supervised step launched a kernel")
    for name, per in PER_TRAIN_STEP.items():
        if counts[name] != per:
            fail(f"supervised step check: {name} launched {counts[name]} times, expected {per}")
    cmp = compare_grads(grads_k, grads_p, _supervised_parts)
    del grads_k, grads_p, model, trainer, loss_fn
    torch.cuda.empty_cache()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    return {"total_loss_kernel": loss_k, "total_loss_plain": loss_p,
            "total_loss_rel_err": loss_rel,
            "share_equal_points": selection_share(sel_k, sel_p,
                                                  supervised_config().criterion.n_pool),
            "groups": cmp,
            "largest_rel_err": max(v["rel_err"] for v in cmp.values()),
            "smallest_cosine": min(v["cosine"] for v in cmp.values()),
            "ok": loss_rel <= SUP_LOSS_REL_ERR_LIMIT and all(
                v["rel_err"] <= SUP_REL_ERR_LIMIT and v["cosine"] >= SUP_COSINE_LIMIT
                for v in cmp.values())}


def supervised_path(seed: int, tmp_root: str, refs: dict):
    """Phase 14: the supervised / fewshot ablation's CLIs as a user runs
    them, in this process, at full width (Swin-L, banded radius-4 sampling,
    bf16, the trunk unfrozen, 40 part classes, the criterion's random point
    mode at 12544 points) over phase 9's PartImageNet-style set and
    ``eval_sets``' Pascal-Parts and Cityscapes-Part sets: ``train-supervised``
    for SUP_TRAIN_STEPS steps at B = CLI_BATCH, resumed to SUP_RESUME_STEPS,
    the fewshot class-agnostic run (``--label-percentage 50
    --class-agnostic``), ``eval-supervised`` on each set, the v1 heads,
    ``rank`` and ``distill-eval`` on the new sets from phases 9 / 10's
    checkpoints; exact launches (every #7 banded). Then the criterion on
    the card against the CPU with a planted sign fault, and the supervised
    step through the kernels against the plain versions."""
    import os
    import shutil

    import torch

    from partdistillation_torch.models.segmenter import MaskFormerSegmenter

    p9, p10 = refs["phase9"], refs["phase10"]
    paths, banded = {}, {}
    tmp = os.path.join(tmp_root, "supervised")
    os.makedirs(tmp)
    t0 = time.perf_counter()
    sets = eval_sets(tmp, seed)
    data_s = time.perf_counter() - t0
    base = [o for o in p9["ov"] if not o.startswith("checkpoint_dir")] + sets

    def common(ckpt):
        return ["--set", *base, f"data.batch_size={CLI_BATCH}", "checkpoint_every=1000",
                "log_every=1", f"checkpoint_dir={os.path.join(tmp, ckpt)}"]

    def steps(per, n):
        return {k: v * n for k, v in per.items()}

    def forwards(n_items, passes=1):
        return steps(PER_FORWARD, passes * -(-n_items // CLI_BATCH))

    def in_range(metrics):
        return all(v is not None and (np.isnan(v) or 0.0 <= v <= 100.0)
                   for v in (metrics.get(k) for k in DISTILL_METRICS))

    runs = {}
    for name, n, before in (("train", SUP_TRAIN_STEPS, 0),
                            ("resume", SUP_RESUME_STEPS, SUP_TRAIN_STEPS)):
        runs[name] = counted_run(paths, banded, f"supervised_train:{name}",
                                 ["train-supervised", *common("ckpt"), f"max_iters={n}"],
                                 steps(PER_TRAIN_STEP, n - before))
        if runs[name]["steps"] != n:
            fail(f"train-supervised ({name}) ended at step {runs[name]['steps']}, not {n}")
    with open(os.path.join(tmp, "ckpt", "logs", "train-supervised", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in logged]
    if [r["step"] for r in logged] != list(range(1, SUP_RESUME_STEPS + 1)) \
            or not all(np.isfinite(losses)):
        fail(f"train-supervised metrics.jsonl: {[(r['step'], r['total_loss']) for r in logged]}")
    # every trunk group and every decoder group moved from the seeded weights
    ckpt = os.path.join(tmp, "ckpt", "supervised")
    model = MaskFormerSegmenter(supervised_config().segmenter, device="cuda", seed=seed)
    init = model.state_dict()
    del model
    state = torch.load(os.path.join(ckpt, sorted(os.listdir(ckpt))[-1]), map_location="cuda",
                       weights_only=True)["model"]
    moved = {}
    for n, v in state.items():
        if n in init and init[n].is_floating_point():
            for group, piece in _supervised_parts(n, (v - init[n]).float()):
                moved[group] = moved.get(group, False) or bool(piece.abs().max() > 0)
    del init, state
    torch.cuda.empty_cache()
    still = sorted(g for g, m in moved.items() if not m)
    if still:
        fail(f"groups left unchanged by train-supervised: {still}")

    few = counted_run(paths, banded, "supervised_train:fewshot",
                      ["train-supervised", "--label-percentage", "50", "--class-agnostic",
                       *common("ckpt_fewshot"), f"max_iters={SUP_SHORT_STEPS}"],
                      steps(PER_TRAIN_STEP, SUP_SHORT_STEPS))
    few_ckpt = os.path.join(tmp, "ckpt_fewshot", "supervised")
    n_pi = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    evals = {}
    for name, ckpt_dir, flags, n_items in (
            ("part_imagenet", ckpt, [], n_pi),
            ("pascal", few_ckpt, ["--class-agnostic"], SUP_PASCAL_IMAGES + 2),
            ("cityscapes", few_ckpt, ["--class-agnostic"], 5 * SUP_CITYSCAPES_IMAGES)):
        ev = counted_run(paths, banded, f"supervised_eval:{name}",
                         ["eval-supervised", "--eval-dataset", name, "--trainer-checkpoint",
                          ckpt_dir, *flags, *common("ckpt_eval")], forwards(n_items))
        if ev["dataset"] != name or not in_range(ev):
            fail(f"eval-supervised {name}: {ev}")
        evals[name] = {k: ev.get(k) for k in (*DISTILL_METRICS, "images_per_sec",
                                               "images_per_sec_steady", "first_batch_s",
                                               "max_memory_allocated_bytes")}
    shutil.rmtree(os.path.join(tmp, "ckpt_fewshot"))

    v1 = {}
    for pd in ("fpn", "transformer_fpn"):
        res = counted_run(paths, banded, f"supervised_v1:{pd}",
                          ["train-supervised", "--pixel-decoder", pd, "--decoder", "standard",
                           *common(f"ckpt_{pd}"), f"max_iters={SUP_SHORT_STEPS}"],
                          steps(PER_V1_STEP, SUP_SHORT_STEPS))
        with open(os.path.join(tmp, f"ckpt_{pd}", "logs", "train-supervised",
                               "metrics.jsonl")) as f:
            v1_losses = [json.loads(line)["total_loss"] for line in f]
        if res["steps"] != SUP_SHORT_STEPS or not all(np.isfinite(v1_losses)):
            fail(f"train-supervised --pixel-decoder {pd} --decoder standard: {res}, "
                 f"losses {v1_losses}")
        v1[pd] = {**{k: res.get(k) for k in CLI_KEYS if k in res}, "total_loss": v1_losses}
        shutil.rmtree(os.path.join(tmp, f"ckpt_{pd}"))

    # the eval sets in the other CLIs: rank on phase 9's stage-3 checkpoint,
    # distill-eval on phase 10's stage-5 checkpoint
    stage3 = os.path.join(next(o.split("=", 1)[1] for o in p9["ov"]
                               if o.startswith("checkpoint_dir=")), "proposal")
    n_pascal = SUP_PASCAL_IMAGES + 2
    rank = counted_run(paths, banded, "supervised_rank:pascal",
                       ["rank", "--eval-dataset", "pascal", "--phases", "cluster,match,eval",
                        "--trainer-checkpoint", stage3, *common("ckpt_rank")],
                       forwards(n_pascal, passes=3))
    bank = np.load(os.path.join(tmp, "ckpt_rank", "rank_centroids_pascal.npz"))["centroids"]
    mapping = np.load(os.path.join(tmp, "ckpt_rank", "rank_mapping_pascal.npz"))["mapping"]
    if bank.shape != (2, 8, 256) or not np.isfinite(bank).all() or mapping.shape != (2, 8) \
            or not in_range(rank["eval"]):
        fail(f"rank on pascal: bank {bank.shape}, mapping {mapping.shape}, {rank['eval']}")
    try:
        run_cli(["rank", "--eval-dataset", "pascal", "--phases", "save",
                 "--trainer-checkpoint", stage3, *common("ckpt_rank")])
        fail("rank --phases save on pascal ran")
    except SystemExit as e:
        refusal = str(e)
    head = ["--num-object-classes", str(DISTILL_OBJECTS), "--num-parts", str(DISTILL_PARTS)]
    distill = counted_run(paths, banded, "supervised_distill:cityscapes",
                          ["distill-eval", "--eval-dataset", "cityscapes", *head,
                           "--trainer-checkpoint",
                           os.path.join(p10["tmp"], "ckpt", "part_distillation"),
                           *common("ckpt_distill")],
                          forwards(5 * SUP_CITYSCAPES_IMAGES, passes=2))
    if distill["dataset"] != "cityscapes" or not in_range(distill):
        fail(f"distill-eval on cityscapes: {distill}")

    crit, planted = criterion_card_vs_cpu(seed)
    torch.cuda.empty_cache()
    step = supervised_step_check(seed)
    train, resume = runs["train"], runs["resume"]
    emit({"phase": "supervised_path", "config": "train-supervised / eval-supervised, full "
          "width: Swin-L/MSDeformAttn banded radius 4/9-layer decoder, bf16, trunk unfrozen, "
          "40 part classes, random point mode (ratio 0.75, 12544 points)",
          "data_setup_s": round(data_s, 3),
          "train": {k: train[k] for k in CLI_KEYS if k in train},
          "resume": {k: resume[k] for k in CLI_KEYS if k in resume},
          "fewshot_class_agnostic": {k: few[k] for k in CLI_KEYS if k in few},
          "launches_per_step": PER_TRAIN_STEP, "total_loss_per_step": losses,
          "groups_moved": f"{len(moved)}/{len(moved)}", "eval": evals,
          "v1_heads": {"launches_per_step": PER_V1_STEP, **v1},
          "rank_pascal": {**rank["eval"], "bank_shape": list(bank.shape),
                          "max_memory_allocated_bytes": rank["max_memory_allocated_bytes"]},
          "rank_save_on_pascal_refused": refusal,
          "distill_eval_cityscapes": {k: distill.get(k) for k in DISTILL_METRICS},
          "criterion_card_vs_cpu": {
              "tolerance": f"kept points equal >= {CRIT_SHARE_LIMIT}, total loss within "
                           f"{CRIT_LOSS_REL_ERR_LIMIT}, gradients within "
                           f"{CRIT_GRAD_REL_ERR_LIMIT} (relative)",
              **crit, "planted_sign_flip": planted},
          "kernels_vs_plain_supervised_step": {
              "tolerance": f"total_loss within {SUP_LOSS_REL_ERR_LIMIT}; per group (trunk and "
                           f"decoder) <= {SUP_REL_ERR_LIMIT} and cosine >= {SUP_COSINE_LIMIT}",
              **step}})
    if not crit["ok"]:
        fail(f"the criterion on the card disagrees with the CPU: {crit}")
    if planted["ok"]:
        fail(f"the criterion check passed a flipped uncertainty: {planted}")
    if not step["ok"]:
        fail("the supervised kernel train step disagrees with the plain-version step")
    return paths, banded


# --------------------------------------------------------------- phase 15


PROFILE_STEPS, VIS_STEPS, VIS_EVERY = 3, 4, 2
PROFILE_SCOPES = ("backbone", "pixel_decoder", "transformer_decoder", "backward")
# the CLIP scorer with host crops against the device crops, the same bf16
# tower: read on an H100 80GB HBM3 at 700 W at seeds 0-2 by
# tools/torch_host_crop_seeds.py (16 boxes an image): ids equal 100 / 96.9 /
# 100 %, probabilities within 0.0087 / 0.0011 / 0.0038; in phase 15 at seed 0
# (phase 12's 8 detect masks and 8 boxes an image) 100 %, 0.0012. The limits
# are about twice the worst of these (the two crops resample differently:
# PIL's bilinear on uint8, JAX's antialiased linear weights in f32)
HOST_CROP_ID_AGREEMENT, HOST_CROP_PROB_LIMIT = 0.9, 0.02


def doctor_report(argv) -> dict:
    """``run.main(["doctor", ...])`` in this process: its report (printed
    as one indented JSON object), or a failure with it when it exits 2."""
    import io

    from partdistillation_torch import run

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            run.main(["doctor", *argv])
    except SystemExit as e:
        fail(f"doctor exited {e.code}: {out.getvalue()}")
    print(out.getvalue(), file=sys.stderr, flush=True)
    return json.loads(out.getvalue())


def host_crops_vs_device(refs: dict) -> dict:
    """Phase 12's CLIP check (its ViT-B/32 bf16 tower, text embeddings,
    images and masks) scored with the host's PIL crops against the device's
    antialiased crops: the share of equal class ids and the largest
    probability difference (the two crops resample differently), held to
    HOST_CROP_ID_AGREEMENT and HOST_CROP_PROB_LIMIT."""
    from partdistillation_torch.models.meta_arch.labeling import clip_region_scorer_device

    c = refs["phase12"]
    got = {}
    for backend in ("device", "host"):
        t = time.perf_counter()
        scorer = clip_region_scorer_device(c["vision"], c["text_emb"], crop_backend=backend)
        got[backend] = (*scorer.batched(c["images"], c["masks"]), time.perf_counter() - t)
    (dev_ids, dev_p, dev_s), (host_ids, host_p, host_s) = got["device"], got["host"]
    agree, diff = float((host_ids == dev_ids).mean()), float(np.abs(host_p - dev_p).max())
    return {"masks": int(np.prod(c["masks"].shape[:2])), "id_agreement": agree,
            "prob_max_abs_diff": diff,
            "ok": bool(agree >= HOST_CROP_ID_AGREEMENT and diff <= HOST_CROP_PROB_LIMIT
                       and np.isfinite(host_p).all()),
            "host_s": round(host_s, 3), "device_s": round(dev_s, 3)}


def host_codec_check(store_dir: str) -> dict:
    """The host codec (C++, built by g++ on this machine) on every part mask
    of a store: decode, then its bytes against the numpy codec's and the
    stored ones."""
    from partdistillation_torch.data.pseudo_store import PseudoLabelStore
    from partdistillation_torch.utils import rle

    n, bad = 0, []
    for record in PseudoLabelStore(store_dir):
        for r in record["part_masks"]:
            m = rle.decode(r)
            if not (rle.encode(m) == rle.encode_plain(m) == r) \
                    or not np.array_equal(m, rle.decode_plain(r)) \
                    or rle.area(r) != rle.area_plain(r):
                bad.append(record["image_id"])
            n += 1
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    return {"masks": n, "records_differing": sorted(set(bad)), "gxx": gxx}


def tools_path(seed: int, tmp_root: str, refs: dict):
    """Phase 15: the tools around the pipeline as a user runs them, in this
    process, at full width over phase 9's data: ``doctor`` (the backend, the
    kernel library and the host codec built), ``profile --steps 3`` (the
    unfrozen stage-3 step, B = CLI_BATCH, 12544 points; exact launches over
    its warm-up and traced steps, the trace written, device time in the
    model's scopes and the backward), ``train-proposal`` with ``vis_every``
    (launches of the steps and of the snapshots' forwards, the PNGs read
    back), ``visualize`` over phase 9's dCRF store; then the host-crop CLIP
    scorer against the device crops on phase 12's check, and the host codec
    on every mask of phase 9's store."""
    import os

    from PIL import Image

    from partdistillation_torch.utils.profiling import TRACE_SUFFIX, summarize_trace

    p9 = refs["phase9"]
    paths, banded = {}, {}
    tmp = os.path.join(tmp_root, "tools")
    os.makedirs(tmp)
    base = [o for o in p9["ov"] if not o.startswith("checkpoint_dir")]

    t0 = time.perf_counter()
    doctor = doctor_report(["--set", f"paths.root={tmp}/doctor_root"])
    doctor_s = time.perf_counter() - t0
    if not (doctor["ok"] and doctor["backend"]["platform"] == "cuda"
            and doctor["kernels"]["ok"] and doctor["host_codec"]["ok"]):
        fail(f"doctor: {doctor}")

    def steps(per, n):
        return {k: v * n for k, v in per.items()}

    trace_dir = os.path.join(tmp, "profile")
    prof = counted_run(paths, banded, "profile",
                       ["profile", "--steps", str(PROFILE_STEPS), "--output", trace_dir,
                        "--set", f"seed={seed}", f"data.batch_size={CLI_BATCH}"],
                       steps(PER_TRAIN_STEP, 1 + PROFILE_STEPS))  # warm-up + traced steps
    scopes = summarize_trace(trace_dir, steps=PROFILE_STEPS)
    if prof["total_ms_per_step"] <= 0 or not all(scopes.get(k, 0.0) > 0 for k in PROFILE_SCOPES) \
            or not os.path.exists(os.path.join(trace_dir, "steps" + TRACE_SUFFIX)):
        fail(f"profile: {prof}, scopes {scopes}")

    ckpt = os.path.join(tmp, "vis_ckpt")
    vis = counted_run(paths, banded, "vis_train",
                      ["train-proposal", "--set", *base, f"data.batch_size={CLI_BATCH}",
                       "checkpoint_every=1000", "log_every=1", f"checkpoint_dir={ckpt}",
                       f"max_iters={VIS_STEPS}", f"vis_every={VIS_EVERY}"],
                      {k: v * VIS_STEPS + PER_FORWARD[k] * (VIS_STEPS // VIS_EVERY)
                       for k, v in PER_TRAIN_STEP.items()})
    vis_dir = os.path.join(ckpt, "logs", "train-proposal", "vis")
    want_pngs = [f"step_{s:06d}.png" for s in range(VIS_EVERY, VIS_STEPS + 1, VIS_EVERY)]
    shape = (CLI_BATCH * (IMAGE_SIZE + 2) - 2, 2 * IMAGE_SIZE + 2, 3)
    pngs = {name: np.asarray(Image.open(os.path.join(vis_dir, name)))
            for name in sorted(os.listdir(vis_dir))}
    if list(pngs) != want_pngs or any(a.shape != shape for a in pngs.values()):
        fail(f"vis_every={VIS_EVERY}: {[(k, a.shape) for k, a in pngs.items()]}, expected "
             f"{want_pngs} of {shape}")

    collage = os.path.join(tmp, "collage.png")
    n_images = len(CLI_CODES) * CLI_IMAGES_PER_CLASS
    shown = counted_run(paths, banded, "visualize",
                        ["visualize", "--output", collage, "--set", *base],
                        {k: 0 for k in PER_FORWARD})
    grid = np.asarray(Image.open(collage))
    rows = -(-n_images // 4)
    if shown["panels"] != n_images or grid.shape != (rows * (IMAGE_SIZE + 2) - 2,
                                                     4 * (IMAGE_SIZE + 2) - 2, 3) \
            or not (grid < 255).any():
        fail(f"visualize: {shown}, collage {grid.shape}")

    crops = host_crops_vs_device(refs)
    if not crops["ok"]:
        fail(f"the host-crop CLIP scorer against the device crops: {crops}")
    store = next(o.split("=", 1)[1] for o in p9["ov"] if o.startswith("paths.root="))
    codec = host_codec_check(os.path.join(store, "proposals_dcrf"))
    if codec["masks"] == 0 or codec["records_differing"]:
        fail(f"the host codec differs from the numpy codec: {codec}")
    emit({"phase": "tools_path", "config": "doctor; profile: the unfrozen stage-3 step at full "
          "width (Swin-L/MSDeformAttn banded radius 4/9-layer decoder, bf16, 12544 points); "
          "train-proposal with vis_every; visualize; the host-crop CLIP scorer; the host codec",
          "doctor": {"s": round(doctor_s, 3), "backend": doctor["backend"],
                     "kernels": doctor["kernels"], "host_codec": doctor["host_codec"]},
          "profile": {"steps": PROFILE_STEPS, "launches_per_step": PER_TRAIN_STEP,
                      "total_ms_per_step": prof["total_ms_per_step"], "top": prof["top"],
                      "scopes_ms_per_step": {k: round(v, 4) for k, v in scopes.items()
                                             if not k.startswith("<")},
                      "unscoped_ms_per_step": round(sum(v for k, v in scopes.items()
                                                        if k.startswith("<")), 4),
                      "max_memory_allocated_bytes": prof["max_memory_allocated_bytes"]},
          "vis_every": {"steps": VIS_STEPS, "every": VIS_EVERY, "pngs": list(pngs),
                        "png_shape": list(shape), "launches_per_vis_forward": PER_FORWARD,
                        **{k: vis[k] for k in CLI_KEYS if k in vis}},
          "visualize": {"panels": shown["panels"], "collage_shape": list(grid.shape)},
          "host_crops_vs_device": {**crops, "limits": {
              "id_agreement": HOST_CROP_ID_AGREEMENT, "prob_max_abs_diff": HOST_CROP_PROB_LIMIT}},
          "host_codec": codec})
    return paths, banded


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the synthetic batches and the kernel inputs")
    ap.add_argument("--torchrun-cli", nargs=2, metavar=("SPEC", "OUT"),
                    help="(phase 13's rank under torchrun) run SPEC's commands, write OUT")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from partdistillation_torch.utils import native_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.torchrun_cli:
        return torchrun_cli_worker(*args.torchrun_cli)

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
    paths = {"inference": main_path(args.seed)}
    torch.cuda.empty_cache()
    paths["train_frozen"] = train_path(args.seed)
    torch.cuda.empty_cache()
    paths["train_unfrozen"] = unfrozen_train_path(args.seed)
    torch.cuda.empty_cache()
    refs = {}  # what phase 13 repeats of phases 9-11
    with tempfile.TemporaryDirectory() as cli_tmp:  # phase 9's data and checkpoints
        cli_paths, cli_banded = cli_path(args.seed, cli_tmp, refs)
        paths.update(cli_paths)
        torch.cuda.empty_cache()
        distill_paths, distill_banded = distill_path(args.seed, cli_tmp, refs)
        paths.update(distill_paths)
        cli_banded.update(distill_banded)
        torch.cuda.empty_cache()
        with tf32_flags_on():  # phases 11 and 12 in a user's process state
            kmeans_paths, kmeans_banded = kmeans_path(args.seed, cli_tmp, refs)
            paths.update(kmeans_paths)
            cli_banded.update(kmeans_banded)
            torch.cuda.empty_cache()
            front_paths, front_banded = front_path(args.seed, cli_tmp, refs)
            paths.update(front_paths)
            cli_banded.update(front_banded)
        torch.cuda.empty_cache()
        paths.update(multi_gpu_path(args.seed, cli_tmp, refs))
        torch.cuda.empty_cache()
        supervised_paths, supervised_banded = supervised_path(args.seed, cli_tmp, refs)
        paths.update(supervised_paths)
        cli_banded.update(supervised_banded)
        torch.cuda.empty_cache()
        tools_paths, tools_banded = tools_path(args.seed, cli_tmp, refs)
        paths.update(tools_paths)
        cli_banded.update(tools_banded)

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
        "window_attention_proj": ("partdistillation_torch/csrc/window_attention_proj.cu",
                                  "partdistillation_tpu/ops/fused_attention.py:389"),
        "msda_folded": ("partdistillation_torch/csrc/msda_folded.cu",
                        "partdistillation_tpu/ops/msda_pallas.py:207"),
        "msda_taps": ("partdistillation_torch/csrc/msda_taps.cu",
                      "partdistillation_tpu/ops/msda_pallas.py:47, "
                      "partdistillation_tpu/ops/msda_pallas.py:93"),
    }
    # the per-tap kernel is on no model path: its path is the bench tool's
    paths["msda_bench"] = {name: 0 for name in meta}
    paths["msda_bench"]["msda_taps"] = checks["msda_taps"]["launches_bench"]
    kernels = []
    for name, (source, replaces) in meta.items():
        c = checks[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        extra = {key: c[key] for key in ("wrapper_ms", "ms_range", "device_ms",
                                         "device_ms_range", "library_ms_range", "by_shape",
                                         "banded") if key in c}
        if name == "msda_folded":
            extra["banded_launches_by_path"] = cli_banded
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
                        "library_ms": c["library_ms"], "shape": c["shape"], **extra})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
