"""Attention with decomposed relative positions (ViTDet, MViTv2): the Triton
kernels (forward, and the backward's two passes) and their plain version.

No TPU kernel of the JAX package computes this: its ``vit_utils`` holds the
helpers and no shipped configuration calls them. The port adds it for the
ViTDet-L backbone (``models/vitdet.py``), whose 20 window blocks attend
inside 14 x 14 windows (196 tokens) and whose 4 global blocks attend over
all 64 x 64 = 4,096 tokens of a 1024 x 1024 image. Each logit carries a
query-dependent bias (``add_decomposed_rel_pos`` upstream): with the keys
laid out as a KH x KW grid,

    logit[q, (kh, kw)] = scale q.k + rel_h[q, kh] + rel_w[q, kw],
    rel_h[q, kh] = q . R_h[q_h - kh + KH - 1],  rel_w likewise,

q unscaled in the two table products. ``decomposed_rel_pos`` computes
rel_h (BH, N, KH) and rel_w (BH, N, KW) in f32 with plain products (q
against every table row, then a gather), which autograd differentiates to
q and both tables; the attention itself is the kernels'. The forward walks
the keys one grid row (kh) at a time, padded to ``BN`` (a power of two, at
least 16): the row's rel_h value is one column a query, rel_w the same
block for every row, so the bias costs one load a row and one add a logit.
The probabilities are online-softmax in f32 (log2 domain) and never
stored; the log-sum-exp (BH, N) is, in f32. The backward
recomputes P from it: ``relpos_attn_bwd_kv_kernel`` (a program per key row)
sums dK and dV over the query blocks, ``relpos_attn_bwd_q_kernel`` (a
program per query block) sums dQ and, from dS in f32, rel_h's gradient (the
row sum of dS, one column a key row) and rel_w's (dS summed over the key
rows). No (BH, N, N) tensor is written in either direction.

Bound (H100, global block, B = 4: BH = 64, N = 4,096, D = 64): 4.4 GFLOP
a head pair forward, 275 GFLOP a block, against 34 MB of q, k, v and the
output: the tensor cores bound it (0.28 ms a block forward at 989 TFLOP/s).
The window blocks (BH = 1,600 windows x heads of 196 tokens) are 16 GFLOP
a block, equally compute-bound in principle; their key rows of 14 pad to
16 columns.

Precision: q, k, v bf16; products accumulate in f32; P is rounded to bf16
for P.V and dV, dS to bf16 for dQ and dK (as ``masked_attention_bwd_plain``
does); the row statistics, rel_h, rel_w and the tables' gradients stay f32.
``relpos_attention_core_plain`` is the same function in f32 products over
the whole (N, N) logits: the CPU path and the kernels' yardstick on the
card.
"""

from __future__ import annotations

import functools
import types
from typing import Tuple

import torch

from ..utils.precision import full_f32
from .autograd import count, route

__all__ = ["relpos_attention", "relpos_attention_plain", "relpos_attention_core_plain",
           "relpos_attention_core", "decomposed_rel_pos",
           "relpos_attention_backward", "relpos_attention_plan"]

_LOG2E = 1.4426950408889634
_MAX_KW = 128  # a key row is one tile of at most this many columns


def decomposed_rel_pos(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                       size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """rel_h (BH, N, H) and rel_w (BH, N, W) in f32 of q (BH, N = H W, D),
    unscaled, as ``add_decomposed_rel_pos`` forms them: q times every row
    of each table in one product, (BH N, D) x (D, 2S - 1), then each query
    row's S entries at its distances gathered (upstream's per-row einsum is
    S small products of width S)."""
    h, w = size
    bh, d = q.shape[0], q.shape[-1]
    for table, n in ((rel_pos_h, h), (rel_pos_w, w)):
        if table.shape[0] != 2 * n - 1:  # upstream resizes; no configuration here needs it
            raise ValueError(f"relative-position table of {table.shape[0]} rows for a side "
                             f"of {n} (needs {2 * n - 1})")
    r_q = q.float().reshape(bh, h, w, d)
    with full_f32(q.device):
        all_h = r_q @ rel_pos_h.float().t()  # (BH, H, W, 2H - 1)
        all_w = r_q @ rel_pos_w.float().t()
    ih, iw = torch.arange(h, device=q.device), torch.arange(w, device=q.device)
    dist_h = (ih[:, None] - ih[None, :] + h - 1)[None, :, None, :].expand(bh, h, w, h)
    dist_w = (iw[:, None] - iw[None, :] + w - 1)[None, None, :, :].expand(bh, h, w, w)
    rel_h = all_h.gather(-1, dist_h)
    rel_w = all_w.gather(-1, dist_w)
    return rel_h.reshape(bh, h * w, h), rel_w.reshape(bh, h * w, w)


def relpos_attention_core_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The kernels' function in plain products: q, k, v (BH, N, D), rel_h
    (BH, N, KH), rel_w (BH, N, KW) f32, N = KH KW. f32 logits and softmax,
    the probabilities in v's dtype for P.V; the output in v's dtype."""
    bh, n, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = (logits.reshape(bh, n, kh, kw) + rel_h[..., :, None] + rel_w[..., None, :])
    probs = logits.reshape(bh, n, n).softmax(-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def relpos_attention_plain(q, k, v, rel_pos_h, rel_pos_w, size: Tuple[int, int],
                           scale: float) -> torch.Tensor:
    """``relpos_attention`` in plain products (every device)."""
    rel_h, rel_w = decomposed_rel_pos(q, rel_pos_h, rel_pos_w, size)
    return relpos_attention_core_plain(q, k, v, rel_h, rel_w, scale)


def relpos_attention(q, k, v, rel_pos_h, rel_pos_w, size: Tuple[int, int],
                     scale: float) -> torch.Tensor:
    """Self-attention of q, k, v (BH, N, D) over an (H, W) token grid
    (N = H W, row-major) with decomposed relative positions from the tables
    ``rel_pos_h`` (2H - 1, D) and ``rel_pos_w`` (2W - 1, D), logits scaled
    by ``scale`` -> (BH, N, D) in v's dtype. CPU tensors take the plain
    version; CUDA tensors the kernels (bf16 q, k, v, D in 16..128 a power
    of two, W <= 128), differentiable to q, k, v and both tables."""
    rel_h, rel_w = decomposed_rel_pos(q, rel_pos_h, rel_pos_w, size)
    return relpos_attention_core(q, k, v, rel_h, rel_w, scale)


def relpos_attention_core(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The attention on (q, k, v, rel_h, rel_w) (``ops/autograd.route``):
    CPU tensors take ``relpos_attention_core_plain``; CUDA tensors the
    forward kernel, and the backward kernels when autograd records a
    gradient for any of them."""
    return route("relpos_attn", relpos_attention_core_plain, _forward, q, k, v, rel_h, rel_w,
                 scale=scale, backward=_relpos_backward)


def _relpos_backward(g, needs, q, k, v, rel_h, rel_w, out, lse, scale):
    return relpos_attention_backward(q, k, v, rel_h, rel_w, out, lse, g.contiguous(), scale)


def relpos_attention_plan(n: int, kh: int, kw: int, d: int) -> dict:
    """The kernels' tiles: ``bn`` columns a key row (KW padded to a power
    of two, at least 16), ``bm`` query rows a forward program (128 where a
    key row fills 64 columns or more, else 64), ``bm_bwd`` query rows a
    backward step, and the warps of each kernel."""
    if n != kh * kw:
        raise ValueError(f"relpos_attention: {n} tokens on a {kh} x {kw} grid")
    if kw > _MAX_KW or d not in (16, 32, 64, 128):
        raise ValueError(f"relpos_attention: key row of {kw} (<= {_MAX_KW}) or head dim {d} "
                         "(16, 32, 64 or 128)")
    bn = max(16, 1 << (kw - 1).bit_length())
    wide = bn >= 64
    return {"bn": bn, "bm": 128 if wide else 64, "bm_bwd": 64,
            "warps_fwd": 8 if wide else 4, "warps_q": 8 if wide else 4, "warps_kv": 4}


def _check(q, k, v, rel_h, rel_w):
    if q.device.type != "cuda":
        raise ValueError(f"relpos_attention: unsupported device {q.device}")
    bh, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    for label, t, dtype, shape in (("q", q, torch.bfloat16, (bh, n, d)),
                                   ("k", k, torch.bfloat16, (bh, n, d)),
                                   ("v", v, torch.bfloat16, (bh, n, d)),
                                   ("rel_h", rel_h, torch.float32, (bh, n, kh)),
                                   ("rel_w", rel_w, torch.float32, (bh, n, kw))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"relpos_attention: {label} must be contiguous {dtype} {shape} "
                             f"on {q.device}")
    return relpos_attention_plan(n, kh, kw, d)


def _forward(q, k, v, rel_h, rel_w, scale: float, round_lse: bool = False):
    """The forward kernel: (out (BH, N, D) bf16, lse (BH, N) f32, log2
    units). ``round_lse`` rounds the stored log-sum-exp to bf16 (a planted
    fault for the tests)."""
    plan = _check(q, k, v, rel_h, rel_w)
    bh, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    if q.numel():
        kern = _kernels()
        grid = (-(-n // plan["bm"]), bh)
        kern.fwd[grid](q, k, v, rel_h, rel_w, out, lse, n, kh, kw, float(scale) * _LOG2E,
                       D=d, BM=plan["bm"], BN=plan["bn"], ROUND_LSE=round_lse,
                       num_warps=plan["warps_fwd"], num_stages=2)
        count("relpos_attention")
    return out, lse


def relpos_attention_backward(q, k, v, rel_h, rel_w, out, lse, g, scale: float):
    """(dq, dk, dv, d rel_h, d rel_w) of the forward kernel's output at the
    output gradient ``g``, from its inputs, output and log-sum-exp. Two
    kernels: dK and dV a key row, dQ and the bias gradients a query block
    (D = rowsum(g o) first, in f32)."""
    plan = _check(q, k, v, rel_h, rel_w)
    bh, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    if not q.numel():
        return dq, dk, dv, drh, drw
    delta = (g.float() * out.float()).sum(-1)
    kern = _kernels()
    args = (q, k, v, rel_h, rel_w, g, lse, delta)
    kern.bwd_kv[(kh, bh)](*args, dk, dv, n, kh, kw, float(scale) * _LOG2E, float(scale),
                          D=d, BM=plan["bm_bwd"], BN=plan["bn"],
                          num_warps=plan["warps_kv"], num_stages=2)
    kern.bwd_q[(-(-n // plan["bm_bwd"]), bh)](*args, dq, drh, drw, n, kh, kw,
                                              float(scale) * _LOG2E, float(scale),
                                              D=d, BM=plan["bm_bwd"], BN=plan["bn"],
                                              num_warps=plan["warps_q"], num_stages=2)
    count("relpos_attention_bwd")
    return dq, dk, dv, drh, drw


@functools.lru_cache(maxsize=None)
def _kernels():
    """The Triton kernels, defined at their first launch (``triton`` is
    imported here, not with the module: the CPU path has no Triton). They
    see ``triton`` and ``tl`` through this module's globals."""
    import triton
    import triton.language as tl

    globals().update(triton=triton, tl=tl)

    @triton.jit
    def relpos_attn_fwd_kernel(Q, K, V, RH, RW, O, LSE, N, KH, KW, qk_scale,
                               D: tl.constexpr, BM: tl.constexpr, BN: tl.constexpr,
                               ROUND_LSE: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1).to(tl.int64)
        offs_m = pid_m * BM + tl.arange(0, BM)
        offs_n = tl.arange(0, BN)
        offs_d = tl.arange(0, D)
        row_ok = offs_m < N
        col_ok = offs_n < KW
        base = bh * N * D
        q = tl.load(Q + base + offs_m[:, None] * D + offs_d[None, :], mask=row_ok[:, None],
                    other=0.0)
        rw = tl.load(RW + bh * N * KW + offs_m[:, None] * KW + offs_n[None, :],
                     mask=row_ok[:, None] & col_ok[None, :], other=0.0) * 1.4426950408889634
        m_i = tl.full((BM,), float("-inf"), tl.float32)
        l_i = tl.zeros((BM,), tl.float32)
        acc = tl.zeros((BM, D), tl.float32)
        for t in range(0, KH):
            keys = t * KW + offs_n
            k = tl.load(K + base + keys[:, None] * D + offs_d[None, :], mask=col_ok[:, None],
                        other=0.0)
            v = tl.load(V + base + keys[:, None] * D + offs_d[None, :], mask=col_ok[:, None],
                        other=0.0)
            rh = tl.load(RH + bh * N * KH + offs_m * KH + t, mask=row_ok,
                         other=0.0) * 1.4426950408889634
            s = tl.dot(q, tl.trans(k)) * qk_scale + rh[:, None] + rw
            s = tl.where(col_ok[None, :], s, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            p = tl.exp2(s - m_new[:, None])
            alpha = tl.exp2(m_i - m_new)
            l_i = l_i * alpha + tl.sum(p, 1)
            acc = acc * alpha[:, None] + tl.dot(p.to(tl.bfloat16), v)
            m_i = m_new
        acc = acc / l_i[:, None]
        tl.store(O + base + offs_m[:, None] * D + offs_d[None, :], acc.to(tl.bfloat16),
                 mask=row_ok[:, None])
        lse = m_i + tl.log2(l_i)
        if ROUND_LSE:
            lse = lse.to(tl.bfloat16).to(tl.float32)
        tl.store(LSE + bh * N + offs_m, lse, mask=row_ok)

    @triton.jit
    def relpos_attn_bwd_kv_kernel(Q, K, V, RH, RW, DO, LSE, DELTA, DK, DV, N, KH, KW,
                                  qk_scale, scale, D: tl.constexpr, BM: tl.constexpr,
                                  BN: tl.constexpr):
        t = tl.program_id(0)
        bh = tl.program_id(1).to(tl.int64)
        offs_n = tl.arange(0, BN)
        offs_d = tl.arange(0, D)
        col_ok = offs_n < KW
        keys = t * KW + offs_n
        base = bh * N * D
        kv_off = base + keys[:, None] * D + offs_d[None, :]
        k = tl.load(K + kv_off, mask=col_ok[:, None], other=0.0)
        v = tl.load(V + kv_off, mask=col_ok[:, None], other=0.0)
        dk = tl.zeros((BN, D), tl.float32)
        dv = tl.zeros((BN, D), tl.float32)
        for start in range(0, N, BM):
            offs_m = start + tl.arange(0, BM)
            row_ok = offs_m < N
            q_off = base + offs_m[:, None] * D + offs_d[None, :]
            q = tl.load(Q + q_off, mask=row_ok[:, None], other=0.0)
            do = tl.load(DO + q_off, mask=row_ok[:, None], other=0.0)
            lse = tl.load(LSE + bh * N + offs_m, mask=row_ok, other=0.0)
            delta = tl.load(DELTA + bh * N + offs_m, mask=row_ok, other=0.0)
            rh = tl.load(RH + bh * N * KH + offs_m * KH + t, mask=row_ok, other=0.0)
            rw = tl.load(RW + bh * N * KW + offs_m[:, None] * KW + offs_n[None, :],
                         mask=row_ok[:, None] & col_ok[None, :], other=0.0)
            s = tl.dot(q, tl.trans(k)) * qk_scale + (rh[:, None] + rw) * 1.4426950408889634
            p = tl.exp2(s - lse[:, None])
            p = tl.where(row_ok[:, None] & col_ok[None, :], p, 0.0)
            dv += tl.dot(tl.trans(p.to(tl.bfloat16)), do)
            dp = tl.dot(do, tl.trans(v))
            ds = p * (dp - delta[:, None])
            dk += tl.dot(tl.trans(ds.to(tl.bfloat16)), q)
        tl.store(DK + kv_off, (dk * scale).to(tl.bfloat16), mask=col_ok[:, None])
        tl.store(DV + kv_off, dv.to(tl.bfloat16), mask=col_ok[:, None])

    @triton.jit
    def relpos_attn_bwd_q_kernel(Q, K, V, RH, RW, DO, LSE, DELTA, DQ, DRH, DRW, N, KH, KW,
                                 qk_scale, scale, D: tl.constexpr, BM: tl.constexpr,
                                 BN: tl.constexpr):
        pid_m = tl.program_id(0)
        bh = tl.program_id(1).to(tl.int64)
        offs_m = pid_m * BM + tl.arange(0, BM)
        offs_n = tl.arange(0, BN)
        offs_d = tl.arange(0, D)
        row_ok = offs_m < N
        col_ok = offs_n < KW
        base = bh * N * D
        q_off = base + offs_m[:, None] * D + offs_d[None, :]
        q = tl.load(Q + q_off, mask=row_ok[:, None], other=0.0)
        do = tl.load(DO + q_off, mask=row_ok[:, None], other=0.0)
        lse = tl.load(LSE + bh * N + offs_m, mask=row_ok, other=0.0)
        delta = tl.load(DELTA + bh * N + offs_m, mask=row_ok, other=0.0)
        rw_off = bh * N * KW + offs_m[:, None] * KW + offs_n[None, :]
        both = row_ok[:, None] & col_ok[None, :]
        rw = tl.load(RW + rw_off, mask=both, other=0.0) * 1.4426950408889634
        dq = tl.zeros((BM, D), tl.float32)
        drw = tl.zeros((BM, BN), tl.float32)
        for t in range(0, KH):
            keys = t * KW + offs_n
            k = tl.load(K + base + keys[:, None] * D + offs_d[None, :], mask=col_ok[:, None],
                        other=0.0)
            v = tl.load(V + base + keys[:, None] * D + offs_d[None, :], mask=col_ok[:, None],
                        other=0.0)
            rh = tl.load(RH + bh * N * KH + offs_m * KH + t, mask=row_ok,
                         other=0.0) * 1.4426950408889634
            s = tl.dot(q, tl.trans(k)) * qk_scale + rh[:, None] + rw
            p = tl.exp2(s - lse[:, None])
            p = tl.where(both, p, 0.0)
            dp = tl.dot(do, tl.trans(v))
            ds = p * (dp - delta[:, None])
            dq += tl.dot(ds.to(tl.bfloat16), k)
            drw += ds
            tl.store(DRH + bh * N * KH + offs_m * KH + t, tl.sum(ds, 1), mask=row_ok)
        tl.store(DQ + q_off, (dq * scale).to(tl.bfloat16), mask=row_ok[:, None])
        tl.store(DRW + rw_off, drw, mask=both)

    return types.SimpleNamespace(fwd=relpos_attn_fwd_kernel, bwd_kv=relpos_attn_bwd_kv_kernel,
                                 bwd_q=relpos_attn_bwd_q_kernel)
