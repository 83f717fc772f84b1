"""Fused attention: Swin window attention, Swin window attention fused
with its output projection (two launches: the attention, then the
projection GEMM), and Mask2Former masked cross-attention, each a
CUDA kernel (``csrc/window_attention.cu``, ``csrc/window_attention_proj.cu``,
``csrc/masked_attention.cu``) with its plain version beside it, and the
masked attention's backward kernel (``csrc/masked_attention_bwd.cu``).

Counterpart of the JAX package's ``ops/fused_attention.py``. Gradients on
CUDA (``ops/autograd.route``): masked attention through its backward kernel,
from q, k, v and what the forward kernel returns (the output, the f32
log-sum-exp and the effective uint8 mask); window attention, with or
without the projection, through the VJP of its plain version, the grouped
bias's gradient summed over its group, as the JAX package's ``custom_vjp``s
do.
"""

from __future__ import annotations

import functools

import torch

from ..utils.native_lib import SM_COUNT, launch
from .autograd import count, route
from .fused_mlp import _ROW_TILE, _column_tile

__all__ = ["fused_window_attention", "fused_window_attention_proj",
           "window_attention_proj_plain", "window_attention_proj_split_plain",
           "window_attention_tokens_plain", "window_attention_proj_plan",
           "fused_masked_attention",
           "fused_masked_attention_bwd", "masked_attention_fwd_lse",
           "window_attention_plain", "masked_attention_plain",
           "masked_attention_split_plain", "masked_attention_plan",
           "masked_attention_bwd_plain", "masked_attention_bwd_split_plain",
           "masked_attention_bwd_plan", "window_attention_plan", "window_attention_work",
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


# The window kernel: one warp per 16 query rows of a (window, head), so at
# most 9 warps (N <= 144) and head widths up to 64; one persistent CTA per SM.
_WIN_MAX_N, _WIN_MAX_D = 144, 64


def window_attention_plan(bw: int, h: int, p: int) -> dict:
    """The window kernel's grid for Bw windows of H heads whose bias has P
    groups (Bw / P consecutive windows per group): ``ctas`` persistent CTAs,
    CTA c taking the items [c U / ctas, (c + 1) U / ctas) of the U = H x Bw
    (window, head) items in (head, window) order, so that consecutive items
    share a bias block and each CTA fetches a block once per run."""
    if p <= 0 or bw % p:
        raise ValueError(f"window_attention_plan: {bw} windows in {p} bias groups")
    items = h * bw
    return {"items": items, "ctas": min(items, SM_COUNT)}


def window_attention_work(plan: dict, h: int):
    """The (window, head) items of each CTA of ``window_attention_plan``, in
    the kernel's order."""
    items, ctas = plan["items"], plan["ctas"]
    bw = items // h
    for cta in range(ctas):
        yield [(u % bw, u // bw) for u in range(items * cta // ctas, items * (cta + 1) // ctas)]


def fused_window_attention(qt, kt, vt, bias, scale: float = 1.0):
    """Window attention in the feature-major domain: qt/kt/vt (B, H, D, N) ->
    (B, H, D, N); GROUPED additive bias (P, H, N, N) with B % P == 0, window bi
    using bias[bi // (B / P)] (Swin window-major order). q is unscaled; the
    1/sqrt(d) ``scale`` is applied in q's dtype. CPU tensors take the plain
    version; CUDA tensors the kernel (bf16 q/k/v, f32 bias)."""
    return route("window_attn", window_attention_plain, _window_kernel, qt, kt, vt, bias,
                 scale=scale)


def _window_kernel(qt, kt, vt, bias, scale: float) -> torch.Tensor:
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
    if n > _WIN_MAX_N or d > _WIN_MAX_D:
        raise ValueError(f"fused_window_attention: N {n} > {_WIN_MAX_N} or "
                         f"D {d} > {_WIN_MAX_D}")
    out = torch.empty_like(qt)
    if out.numel() == 0:
        return out
    plan = window_attention_plan(b, h, p)
    # 16-byte copies and paired loads and stores need aligned rows and bases
    vec = int(n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (qt, kt, vt, bias, out)))
    launch("pd_window_attention", qt.device, qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
           bias.data_ptr(), out.data_ptr(), b, h, d, n, p, plan["ctas"], vec, float(scale))
    count("fused_window_attention")
    return out


def window_attention_proj_plain(qt, kt, vt, bias, w, b, scale: float = 1.0):
    """Plain version of the window-attention + projection kernel: the window
    attention's plain version, its (B, H, D, N) output in qt's dtype read as
    (B, N, H*D), times w^T with f32 accumulation, plus b, one rounding."""
    bb, h, d, n = qt.shape
    attn = window_attention_plain(qt, kt, vt, bias, scale).reshape(bb, h * d, n)
    y = _mm_f32(attn.transpose(1, 2), w.t())
    if b is not None:
        y = y + b.float()
    return y.to(qt.dtype)


def window_attention_tokens_plain(qt, kt, vt, bias, scale: float = 1.0):
    """Plain version of the kernel's attention launch: the window attention's
    plain version, each head's output in qt's dtype, token-major:
    A (B*N, H*D), row w*N + i, columns h*D .. h*D + D - 1 for head h."""
    bb, h, d, n = qt.shape
    out = window_attention_plain(qt, kt, vt, bias, scale)
    return out.permute(0, 3, 1, 2).reshape(bb * n, h * d)


def window_attention_proj_split_plain(qt, kt, vt, bias, w, b, scale: float = 1.0):
    """Plain version of the kernel's two launches: A from
    ``window_attention_tokens_plain``, then the projection A w^T with f32
    accumulation over H*D, b added last in f32, one rounding; (B, N, C)."""
    bb, _, _, n = qt.shape
    y = _mm_f32(window_attention_tokens_plain(qt, kt, vt, bias, scale), w.t())
    if b is not None:
        y = y + b.float()
    return y.to(qt.dtype).reshape(bb, n, w.shape[0])


@functools.lru_cache(maxsize=256)
def window_attention_proj_plan(bw: int, h: int, d: int, n: int, c: int, p: int) -> dict:
    """The kernel's two launches for Bw windows of N tokens, H heads of width
    D and bias in P groups, projected to C: the attention launch's
    persistent CTAs (``ctas``, ``window_attention_plan``) and the projection
    GEMM over ``rows`` = Bw*N rows, with its column tile ``bn``
    (``fused_mlp._column_tile``) and output ``tiles``. Cached: the wrapper
    asks once per call; callers must not mutate it."""
    rows = bw * n
    bn = _column_tile(rows, c)
    return {"ctas": window_attention_plan(bw, h, p)["ctas"], "rows": rows, "bn": bn,
            "tiles": -(-rows // _ROW_TILE) * -(-c // bn)}


def fused_window_attention_proj(qt, kt, vt, bias, w, b, scale: float = 1.0):
    """Window attention fused with the output projection: qt/kt/vt
    (B, H, D, N) feature-major with the GROUPED additive bias (P, H, N, N) of
    ``fused_window_attention``, projection weight ``w`` (C, H*D) in
    ``nn.Linear`` layout and bias ``b`` (C,) or None -> (B, N, C)
    token-major. CPU tensors take the plain version; CUDA tensors the kernel
    (bf16 q/k/v, w and b, f32 bias; H*D and C multiples of 16, N <= 144,
    D <= 64), two launches: the attention writes each head's bf16 output
    token-major into a (B*N, H*D) scratch in device memory, which the
    projection GEMM then reads."""
    return route("window_attn_proj", window_attention_proj_plain, _window_proj_kernel, qt, kt,
                 vt, bias, w, b, scale=scale)


def _window_proj_attention(qt, kt, vt, bias, scale: float, ctas: int) -> torch.Tensor:
    """The kernel's attention launch on checked inputs: A (B*N, H*D) bf16."""
    bb, h, d, n = qt.shape
    a = torch.empty((bb * n, h * d), dtype=qt.dtype, device=qt.device)
    # 16-byte copies and paired bias loads need aligned rows and bases
    vec = int(n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (qt, kt, vt, bias)))
    launch("pd_window_proj_attention", qt.device, qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
           bias.data_ptr(), a.data_ptr(), bb, h, d, n, bias.shape[0], ctas, vec, float(scale))
    return a


def _window_proj_kernel(qt, kt, vt, bias, w, b, scale: float) -> torch.Tensor:
    if qt.device.type != "cuda":
        raise ValueError(f"fused_window_attention_proj: unsupported device {qt.device}")
    bb, h, d, n = qt.shape
    c = w.shape[0]
    if b is None:
        b = torch.zeros(c, dtype=w.dtype, device=w.device)
    for name, t, shape in (("qt", qt, (bb, h, d, n)), ("kt", kt, (bb, h, d, n)),
                           ("vt", vt, (bb, h, d, n)), ("w", w, (c, h * d)), ("b", b, (c,))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or t.device != qt.device or not t.is_contiguous():
            raise ValueError(f"fused_window_attention_proj: {name} must be contiguous "
                             f"bf16 {shape} on {qt.device}")
    p = bias.shape[0]
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (p, h, n, n)
            or bias.device != qt.device or not bias.is_contiguous() or bb % p):
        raise ValueError("fused_window_attention_proj: bias must be contiguous f32 "
                         f"(P, {h}, {n}, {n}) with {bb} % P == 0")
    if n > _WIN_MAX_N or d > _WIN_MAX_D:
        raise ValueError(f"fused_window_attention_proj: N {n} > {_WIN_MAX_N} or "
                         f"D {d} > {_WIN_MAX_D}")
    if (h * d) % 16 or c % 16 or w.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"fused_window_attention_proj: H*D {h * d} and C {c} must be "
                         "multiples of 16, w and b 16-byte aligned (TMA)")
    out = torch.empty((bb, n, c), dtype=qt.dtype, device=qt.device)
    if out.numel() == 0:
        return out
    plan = window_attention_proj_plan(bb, h, d, n, c, p)
    a = _window_proj_attention(qt, kt, vt, bias, scale, plan["ctas"])
    launch("pd_window_proj_gemm", qt.device, a.data_ptr(), w.data_ptr(), b.data_ptr(),
           out.data_ptr(), plan["rows"], c, h * d, plan["bn"])
    count("window_attention_proj")
    return out


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


def masked_attention_split_plain(q, k, v, block_mask, n_split: int):
    """Plain version of the forward kernel's algorithm: the keys cut into
    ``n_split`` contiguous splits (sizes differing by at most one), each
    giving f32 partials (o = exp(s - m) in v's dtype times v, its row max m
    and sum l; m = -inf, l = 0 where a row sees no unblocked key), merged by
    log-sum-exp. Returns (out in v's dtype, f32 lse (B, H, Q))."""
    nk = k.shape[2]
    if not 1 <= n_split <= nk:
        raise ValueError(f"masked_attention_split_plain: n_split {n_split} for {nk} keys")
    logits = _mm_f32(q, k.transpose(-1, -2))
    if block_mask is not None:
        logits = logits.masked_fill(_unblock_full_rows(block_mask), float("-inf"))
    bounds = [nk * i // n_split for i in range(n_split + 1)]
    os_, ms, ls = [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        s = logits[..., lo:hi]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
        os_.append(_mm_f32(p.to(v.dtype), v[:, :, lo:hi]))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
    m_max = torch.stack(ms).amax(0)
    w = [torch.where(m == float("-inf"), 0.0, torch.exp(m - m_max)) for m in ms]
    l = sum(wi * li for wi, li in zip(w, ls))
    o = sum(wi * oi for wi, oi in zip(w, os_))
    out = (o / torch.where(l > 0, l, 1.0)).to(v.dtype)
    lse = torch.where(l > 0, m_max + torch.log(l), float("-inf")).squeeze(-1)
    return out, lse


# The forward kernel: 16 query rows and up to 8 heads per CTA (one warp per
# head, the product of heads and head width at most 256), keys in tiles of 32,
# split over CTAs until the grid has two CTAs per SM of the H100.
_Q_ROWS, _FWD_KEY_TILE, _MAX_GROUP, _GROUP_WIDTH = 16, 32, 8, 256
_FWD_MIN_CTAS = 2 * SM_COUNT


def masked_attention_plan(b: int, h: int, nq: int, nk: int, d: int) -> dict:
    """The forward kernel's grid for (B, H, Q, D) queries against K keys:
    heads per CTA (``group``), key tiles per split, splits and CTAs."""
    group = max(g for g in range(1, min(h, _MAX_GROUP) + 1)
                if h % g == 0 and g * d <= _GROUP_WIDTH)
    base = b * (h // group) * -(-nq // _Q_ROWS)
    key_tiles = -(-nk // _FWD_KEY_TILE)
    tiles_per_split = max(1, key_tiles // -(-_FWD_MIN_CTAS // base))
    n_split = -(-key_tiles // tiles_per_split)
    return {"group": group, "tiles_per_split": tiles_per_split, "n_split": n_split,
            "ctas": base * n_split}


def masked_attention_bwd_plain(q, k, v, block_mask, g):
    """Plain version of the backward kernel, as the JAX package's
    ``_bwd_kernel`` computes it: f32 P = softmax(q k^T + mask), dV = P^T g with
    P in g's dtype, dP = g v^T, dS = P (dP - rowsum(P dP)) cast to q's dtype,
    dQ = dS k, dK = dS^T q (f32 accumulation). Returns (dq, dk, dv)."""
    logits = _mm_f32(q, k.transpose(-1, -2))
    if block_mask is not None:
        logits = logits.masked_fill(_unblock_full_rows(block_mask), -1e9)
    p = torch.softmax(logits, dim=-1)
    dv = _mm_f32(p.to(g.dtype).transpose(-1, -2), g).to(v.dtype)
    dp = _mm_f32(g, v.transpose(-1, -2))
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).to(q.dtype)
    dq = _mm_f32(ds, k).to(q.dtype)
    dk = _mm_f32(ds.transpose(-1, -2), q).to(k.dtype)
    return dq, dk, dv


# The backward kernel: one warp per head of a group (as the forward), each
# warp owning ``key_sub`` sub-tiles of 16 keys (dK and dV stay in its
# registers: key_sub x D f32 a thread, at most 64 unless D alone is more) and
# walking query tiles of 16 rows; the keys split into blocks, the query tiles
# into splits, until the grid has two CTAs per SM of the H100.
_BWD_MIN_CTAS = 2 * SM_COUNT


def masked_attention_bwd_plan(b: int, h: int, nq: int, nk: int, d: int) -> dict:
    """The backward kernel's grid: heads per CTA (``group``, as the forward),
    keys per CTA (``keys_per_block`` = 16 x ``key_sub``) and query tiles of
    16 per split. Among the partitions that reach two CTAs per SM, the one
    that writes the fewest f32 partial bytes: dQ once per key block, dK and
    dV once per query split when there is more than one."""
    group = max(g for g in range(1, min(h, _MAX_GROUP) + 1)
                if h % g == 0 and g * d <= _GROUP_WIDTH)
    base = b * (h // group)
    q_tiles = -(-nq // _Q_ROWS)
    options = []
    for key_sub in (4, 2, 1):
        if key_sub > 1 and key_sub * d > 64:
            continue
        key_blocks = -(-nk // (_Q_ROWS * key_sub))
        need = -(-_BWD_MIN_CTAS // (base * key_blocks))
        tiles_per_split = max(1, q_tiles // need)
        q_split = -(-q_tiles // tiles_per_split)
        partial_bytes = 4 * b * h * d * (key_blocks * nq + (2 * q_split * nk if q_split > 1 else 0))
        options.append({"group": group, "key_sub": key_sub, "keys_per_block": 16 * key_sub,
                        "key_blocks": key_blocks, "q_tiles_per_split": tiles_per_split,
                        "q_split": q_split, "ctas": base * key_blocks * q_split,
                        "partial_bytes": partial_bytes})
    full = [o for o in options if o["ctas"] >= _BWD_MIN_CTAS]
    if full:
        return min(full, key=lambda o: o["partial_bytes"])
    return max(options, key=lambda o: (o["ctas"], -o["partial_bytes"]))


def masked_attention_bwd_split_plain(q, k, v, mask, out, lse, g, plan: dict | None = None):
    """Plain version of the backward kernel's algorithm on the forward's
    effective ``mask`` (True / nonzero = blocked), output and f32 ``lse``:
    P = exp(q k^T - lse) (0 where blocked), D = rowsum(g o) in f32, dP = g
    v^T, dS = P (dP - D); P and dS rounded to g's and q's dtype; dV = P^T g
    and dK = dS^T q as f32 partials per query split of ``plan`` (by default
    ``masked_attention_bwd_plan``), dQ = dS k per key block, each summed in
    order and rounded once. Returns (dq, dk, dv)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    plan = plan or masked_attention_bwd_plan(b, h, nq, nk, d)
    s = _mm_f32(q, k.transpose(-1, -2))
    # exp in f64, rounded once: torch's f32 exp on the CPU has been seen to
    # lose accuracy (about 2^-13 relative) on some calls, which dS's
    # cancellation would carry into the gradients
    p = torch.where(mask.bool(), 0.0, torch.exp((s - lse.float()[..., None]).double()).float())
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    ds = (p * (_mm_f32(g, v.transpose(-1, -2)) - delta)).to(q.dtype)
    p = p.to(g.dtype)
    rows = _Q_ROWS * plan["q_tiles_per_split"]
    dk = dv = torch.zeros((b, h, nk, d), dtype=torch.float32, device=q.device)
    for lo in range(0, nq, rows):
        dv = dv + _mm_f32(p[:, :, lo:lo + rows].transpose(-1, -2), g[:, :, lo:lo + rows])
        dk = dk + _mm_f32(ds[:, :, lo:lo + rows].transpose(-1, -2), q[:, :, lo:lo + rows])
    keys = plan["keys_per_block"]
    dq = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
    for lo in range(0, nk, keys):
        dq = dq + _mm_f32(ds[..., lo:lo + keys], k[:, :, lo:lo + keys])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(name, q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for label, t, shape in (("q", q, (b, h, nq, d)), ("k", k, (b, h, nk, d)),
                            ("v", v, (b, h, nk, d))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous bf16 {shape} on {q.device}")
    if d % 16 or d > 128:
        raise ValueError(f"{name}: head dim {d} (multiple of 16, <= 128)")


def _effective_mask(q, k, block_mask) -> torch.Tensor:
    """The uint8 (B, 1|H, Q, K) mask the kernels read: 1 = blocked, after the
    all-blocked-row fix-up; all zeros (shared across heads) without a mask."""
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    if block_mask is None:
        return torch.zeros((b, 1, nq, nk), dtype=torch.uint8, device=q.device)
    if (block_mask.dtype != torch.bool or block_mask.dim() != 4
            or tuple(block_mask.shape[2:]) != (nq, nk)
            or block_mask.shape[0] != b or block_mask.shape[1] not in (1, h)):
        raise ValueError("fused_masked_attention: block_mask must be bool "
                         f"({b}, 1|{h}, {nq}, {nk})")
    return _unblock_full_rows(block_mask).to(torch.uint8).contiguous()


def _masked_fwd(q, k, v, mask, lse):
    """The forward kernel's launches on the uint8 effective ``mask``: the
    split pass and, with more than one split, the merge."""
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k, v, mask)):
        raise ValueError("fused_masked_attention: q, k, v and the mask must be 16-byte aligned")
    plan = masked_attention_plan(b, h, nq, nk, d)
    parts = (None, None)
    if plan["n_split"] > 1:
        parts = (torch.empty((plan["n_split"], b, h, nq, d), dtype=torch.float32, device=q.device),
                 torch.empty((plan["n_split"], b, h, nq, 2), dtype=torch.float32, device=q.device))
    launch("pd_masked_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           mask.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
           *(None if t is None else t.data_ptr() for t in parts), b, h, nq, nk, d,
           mask.shape[1], plan["group"], plan["tiles_per_split"], plan["n_split"])
    count("fused_masked_attention")
    return out


def masked_attention_fwd_lse(q, k, v, block_mask=None):
    """The forward kernel with its f32 log-sum-exp (B, H, Q): returns
    (out, lse, mask) with ``mask`` the uint8 effective mask, i.e. what the
    backward kernel takes. CUDA tensors only."""
    _check_qkv("masked_attention_fwd_lse", q, k, v)
    mask = _effective_mask(q, k, block_mask)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _masked_fwd(q, k, v, mask, lse), lse, mask


def fused_masked_attention_bwd(q, k, v, mask, out, lse, g):
    """The backward kernel: (dq, dk, dv) of masked attention at the output
    gradient ``g``, from the forward's inputs, its uint8 effective ``mask``,
    its output and log-sum-exp (``masked_attention_fwd_lse``). Three launches:
    D = rowsum(g o), the one pass over (query tile, key block) pairs, and the
    ordered sum of the f32 partials."""
    _check_qkv("fused_masked_attention_bwd", q, k, v)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    for label, t, dtype, shape in (("out", out, torch.bfloat16, (b, h, nq, d)),
                                   ("g", g, torch.bfloat16, (b, h, nq, d)),
                                   ("lse", lse, torch.float32, (b, h, nq)),
                                   ("mask", mask, torch.uint8, (b, mask.shape[1], nq, nk))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != q.device \
                or not t.is_contiguous() or mask.shape[1] not in (1, h):
            raise ValueError(f"fused_masked_attention_bwd: {label} must be contiguous "
                             f"{dtype} {shape} on {q.device}")
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if any(t.data_ptr() % 16 for t in (q, k, v, mask, out, g)):
        raise ValueError("fused_masked_attention_bwd: q, k, v, the mask, out and g "
                         "must be 16-byte aligned")
    plan = masked_attention_bwd_plan(b, h, nq, nk, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, nq), **f32)
    dq_part = torch.empty((plan["key_blocks"], b, h, nq, d), **f32)
    dkv_part = (torch.empty((plan["q_split"], 2, b, h, nk, d), **f32)
                if plan["q_split"] > 1 else None)
    launch("pd_masked_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           mask.data_ptr(), out.data_ptr(), lse.data_ptr(), g.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), dq_part.data_ptr(),
           None if dkv_part is None else dkv_part.data_ptr(), b, h, nq, nk, d, mask.shape[1],
           plan["group"], plan["key_sub"], plan["q_tiles_per_split"], plan["q_split"])
    count("fused_masked_attention_bwd")
    return dq, dk, dv


def _masked_backward(g, needs, q, k, v, out, lse, mask):
    return fused_masked_attention_bwd(q, k, v, mask, out, lse, g.contiguous())


def fused_masked_attention(q, k, v, block_mask=None):
    """Masked attention (B, H, Q, D) x (B, H, K, D) -> (B, H, Q, D).

    q must be pre-scaled. ``block_mask``: optional (B, 1|H, Q, K) bool, True =
    the pair may NOT attend; rows whose keys are all blocked are unblocked
    first. CPU tensors take the plain version (autograd through it); CUDA
    tensors the kernel (bf16, D a multiple of 16 up to 128), and when autograd
    records a gradient for q, k or v, the backward kernel too."""
    # block_mask is bound to the forward, not a static argument, so that the
    # backward (which takes the kernel's effective mask) does not keep it
    return route("masked_attn", functools.partial(masked_attention_plain, block_mask=block_mask),
                 functools.partial(masked_attention_fwd_lse, block_mask=block_mask), q, k, v,
                 backward=_masked_backward)
