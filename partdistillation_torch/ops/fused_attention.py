"""Fused attention: Swin window attention and Mask2Former masked
cross-attention, each a CUDA kernel (``csrc/window_attention.cu``,
``csrc/masked_attention.cu``) with its plain version beside it.

Counterpart of the JAX package's ``ops/fused_attention.py`` (forward
kernels only; the masked-attention backward belongs to the training slice).
"""

from __future__ import annotations

import torch

from ..utils.native_lib import check, load_library

__all__ = ["fused_window_attention", "fused_masked_attention",
           "window_attention_plain", "masked_attention_plain",
           "attention_reference", "attention_reference_t"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with compute-dtype operands and f32 accumulation."""
    return torch.matmul(a.float(), b.float())


def attention_reference(q, k, v, neg_mask):
    """q, k, v (B, H, Q|K, D); neg_mask (B, 1|H, Q, K) additive f32 or None.
    f32 logits and softmax; probabilities cast to v's dtype for P.V."""
    logits = _mm_f32(q, k.transpose(-1, -2))
    if neg_mask is not None:
        logits = logits + neg_mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return _mm_f32(probs, v).to(v.dtype)


def attention_reference_t(qt, kt, vt, neg_mask, scale: float = 1.0):
    """Feature-major form: qt/kt/vt (B, H, D, N), neg_mask (B|1, H, Nq, Nk)
    additive; q scaled in its own dtype first. Returns (B, H, D, Nq)."""
    qs = qt * torch.tensor(scale, dtype=qt.dtype)
    logits = _mm_f32(qs.transpose(-1, -2), kt)
    if neg_mask is not None:
        logits = logits + neg_mask
    probs = torch.softmax(logits, dim=-1).to(vt.dtype)
    return _mm_f32(vt, probs.transpose(-1, -2)).to(vt.dtype)


def window_attention_plain(qt, kt, vt, bias, scale: float = 1.0):
    """Plain version of the window kernel: the grouped bias (P, H, N, N) is
    expanded so that window bi uses bias[bi // (B / P)]."""
    b = qt.shape[0]
    full = bias if bias.shape[0] == 1 else bias.repeat_interleave(
        b // bias.shape[0], dim=0)
    return attention_reference_t(qt, kt, vt, full.float(), scale)


def fused_window_attention(qt, kt, vt, bias, scale: float = 1.0):
    """Window attention in the feature-major domain: qt/kt/vt (B, H, D, N) ->
    (B, H, D, N); GROUPED additive bias (P, H, N, N) with B % P == 0, window bi
    using bias[bi // (B / P)] (Swin window-major order). q is unscaled; the
    1/sqrt(d) ``scale`` is applied in q's dtype. CPU tensors take the plain
    version; CUDA tensors the kernel (bf16 q/k/v, f32 bias)."""
    if qt.device.type == "cpu":
        return window_attention_plain(qt, kt, vt, bias, scale)
    if qt.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {qt.device}")
    b, h, d, n = qt.shape
    for name, t in (("qt", qt), ("kt", kt), ("vt", vt)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (b, h, d, n) \
                or t.device != qt.device or not t.is_contiguous():
            raise ValueError(f"fused_window_attention: {name} must be contiguous "
                             f"bf16 {(b, h, d, n)} on {qt.device}")
    p = bias.shape[0]
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (p, h, n, n)
            or bias.device != qt.device or not bias.is_contiguous() or b % p):
        raise ValueError("fused_window_attention: bias must be contiguous f32 "
                         f"(P, {h}, {n}, {n}) with {b} % P == 0")
    out = torch.empty_like(qt)
    if out.numel() == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(qt.device).cuda_stream
    rc = lib.pd_window_attention(qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), b, h, d, n, p,
                                 float(scale), stream)
    fused_window_attention.launches += 1
    check(rc, "pd_window_attention")
    return out


fused_window_attention.launches = 0


def _unblock_full_rows(block_mask: torch.Tensor) -> torch.Tensor:
    """Mask2Former fix-up: rows whose keys are all blocked attend everything."""
    return block_mask & ~block_mask.all(dim=-1, keepdim=True)


def masked_attention_plain(q, k, v, block_mask=None):
    """Plain version of the masked-attention kernel (fix-up included)."""
    neg = None
    if block_mask is not None:
        neg = torch.where(_unblock_full_rows(block_mask),
                          torch.tensor(-1e9, dtype=torch.float32, device=q.device),
                          torch.tensor(0.0, dtype=torch.float32, device=q.device))
    return attention_reference(q, k, v, neg)


def fused_masked_attention(q, k, v, block_mask=None):
    """Masked attention (B, H, Q, D) x (B, H, K, D) -> (B, H, Q, D).

    q must be pre-scaled. ``block_mask``: optional (B, 1|H, Q, K) bool, True =
    the pair may NOT attend; rows whose keys are all blocked are unblocked
    first. CPU tensors take the plain version; CUDA tensors the kernel (bf16,
    D a multiple of 16 up to 128)."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, block_mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_masked_attention: unsupported device {q.device}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for name, t, shape in (("q", q, (b, h, nq, d)), ("k", k, (b, h, nk, d)),
                           ("v", v, (b, h, nk, d))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"fused_masked_attention: {name} must be contiguous "
                             f"bf16 {shape} on {q.device}")
    if d % 16 or d > 128:
        raise ValueError(f"fused_masked_attention: head dim {d} (multiple of 16, <= 128)")
    if block_mask is None:
        mask = torch.zeros((b, 1, nq, nk), dtype=torch.uint8, device=q.device)
    else:
        if (block_mask.dtype != torch.bool or block_mask.dim() != 4
                or tuple(block_mask.shape[2:]) != (nq, nk)
                or block_mask.shape[0] != b or block_mask.shape[1] not in (1, h)):
            raise ValueError("fused_masked_attention: block_mask must be bool "
                             f"({b}, 1|{h}, {nq}, {nk})")
        mask = _unblock_full_rows(block_mask).to(torch.uint8).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pd_masked_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 mask.data_ptr(), out.data_ptr(), b, h, nq, nk, d,
                                 mask.shape[1], stream)
    fused_masked_attention.launches += 1
    check(rc, "pd_masked_attention")
    return out


fused_masked_attention.launches = 0
