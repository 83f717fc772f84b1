"""Swin MLP half-block LN -> fc1 -> GELU -> fc2 (+ residual): the CUDA kernel
``csrc/fused_mlp.cu`` and its plain version.

Counterpart of the JAX package's ``ops/fused_mlp.py``. Weights are in
``nn.Linear`` layout: ``w1`` (4C, C), ``w2`` (C, 4C).

The JAX package runs its kernel at Swin-L res2-res4 only and falls back to
``ln_mlp_reference`` (LayerNorm statistics in the compute dtype) at res5,
where the weight pair exceeds the TPU's VMEM. The port runs its kernel at all
four stages, so at res5 in bf16 it differs from the JAX package by the bf16
rounding of those statistics.

On CUDA one call makes three launches (the LayerNorm pass and the GEMM
kernel for fc1 and for fc2, ``csrc/fused_mlp.cu``) and counts as one launch
of ``fused_ln_mlp`` (``ops/autograd.LAUNCHES``); ``mlp_plan`` chooses each GEMM's column tile. Its gradient,
where autograd records, is the backward kernels' (``csrc/fused_mlp_bwd.cu``,
``fused_ln_mlp_backward``; ``mlp_bwd_plan`` chooses their tiles and split-K
factors): bf16 product operands with f32 accumulation, as the forward's, and
f32 statistics, GELU' and sums. ``ln_mlp_bwd_plain`` is that algorithm in
PyTorch. CPU tensors take ``ln_mlp_kernel_numerics`` and its autograd, the
function the JAX package's ``custom_vjp`` differentiates.
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils.native_lib import SM_COUNT, launch
from .autograd import count, route

__all__ = ["fused_ln_mlp", "fused_ln_mlp_backward", "ln_mlp_bwd_plain",
           "ln_mlp_kernel_numerics", "ln_mlp_reference", "mlp_bwd_plan", "mlp_plan"]

# the GEMM kernel's row tile, its column tiles, and a tile's fixed cost in
# columns' worth of work
_ROW_TILE, _COLUMN_TILES, _TILE_COST = 128, (128, 96, 64), 32
# the backward GEMM's column tiles and K tile, and a split's fixed cost in
# K tiles: its 128 x BN f32 slice written, then read again by the sum
_BWD_TILES, _K_TILE, _SPLIT_COST = (128, 64), 64, 16
# fused_ln_mlp_backward's gradients, in argument order, as flag bits, and the residual's
_GRADS = ("x", "scale", "bias", "w1", "b1", "w2", "b2")
_RESIDUAL = 1 << len(_GRADS)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with compute-dtype operands and f32 accumulation."""
    return a.float() @ w.float().t()


def ln_mlp_kernel_numerics(x, scale, bias, w1, b1, w2, b2, eps: float = 1e-5,
                           add_residual: bool = True) -> torch.Tensor:
    """Plain version of the kernel: one-pass f32 LayerNorm statistics, the
    normalised row cast to x.dtype, f32 accumulation, exact f32 GELU, hidden
    cast to x.dtype before fc2, residual added in x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    xn = (xf - mean) * torch.rsqrt(var + eps)
    xn = xn * scale.float() + bias.float()
    h = _mm_f32(xn.to(x.dtype), w1) + b1.float()
    h = 0.5 * h * (1.0 + torch.erf(h * (2.0 ** -0.5)))
    y = _mm_f32(h.to(x.dtype), w2) + b2.float()
    if add_residual:
        return x + y.to(x.dtype)
    return y.to(x.dtype)


def ln_mlp_reference(x, scale, bias, w1, b1, w2, b2, eps: float = 1e-5,
                     dtype=torch.bfloat16, add_residual: bool = True) -> torch.Tensor:
    """The JAX package's unfused composition: LayerNorm statistics and every
    operation in ``dtype`` (what it runs at Swin-L res5). For tests."""
    xd = x.to(dtype)
    mean = xd.mean(-1, keepdim=True)
    var = (xd * xd).mean(-1, keepdim=True) - mean * mean
    y = (xd - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(dtype) + bias.to(dtype)
    h = torch.nn.functional.linear(y, w1.to(dtype), b1.to(dtype))
    h = torch.nn.functional.gelu(h)
    o = torch.nn.functional.linear(h, w2.to(dtype), b2.to(dtype))
    return x + o if add_residual else o


def fused_ln_mlp(x, scale, bias, w1, b1, w2, b2, eps: float = 1e-5,
                 add_residual: bool = True) -> torch.Tensor:
    """x (..., C) -> x + fc2(gelu(fc1(LN(x)))), or the branch alone with
    ``add_residual=False``. All operands in x's dtype. CPU tensors take the
    plain version; CUDA tensors the kernel (bf16, C and F multiples of 16,
    16-byte aligned)."""
    return route("ln_mlp", ln_mlp_kernel_numerics, _ln_mlp_kernel, x, scale, bias, w1, b1, w2,
                 b2, eps=eps, add_residual=add_residual, backward=_ln_mlp_backward)


def _ln_mlp_backward(grad, needs, x, scale, bias, w1, b1, w2, b2, eps, add_residual):
    return fused_ln_mlp_backward(grad, x, scale, bias, w1, b1, w2, eps=eps,
                                 add_residual=add_residual, needs=needs)


def _column_tile(m: int, n: int, tiles=_COLUMN_TILES) -> int:
    """The kernel's column tile (128, 96 or 64; ``tiles`` to choose among
    others) that gives the busiest SM the least work: rounds of two resident
    CTAs per SM times the tile's width plus a fixed per-tile cost worth 32
    columns; ties go to the wider tile. On the H100 its choice is within 1 %
    of the fastest tile for six of the eight main-path GEMMs and within 7 %
    for the other two (``tools/torch_kernel_breakdown.py --tiles``, PERF.md)."""
    rows = -(-m // _ROW_TILE)

    def cost(bn):
        return -(-rows * -(-n // bn) // (2 * SM_COUNT)) * (bn + _TILE_COST)

    return min(tiles, key=lambda bn: (cost(bn), -bn))


def _split_k(m: int, n: int, k: int) -> tuple:
    """(column tile, splits) of a weight-gradient GEMM (M, N) over K tokens:
    the pair with the least work on the busiest SM, each SM taking its share
    of the work items (output tiles x splits; its two resident CTAs share its
    tensor cores), an item costing its K tiles plus ``_SPLIT_COST`` when split,
    times the tile's width plus ``_TILE_COST``; ties go to fewer splits and
    the wider tile. At most 4 items per SM are tried: more only shortens
    ragged rounds."""
    ktiles = -(-k // _K_TILE)
    best = None
    for bn in _BWD_TILES:
        tiles = -(-m // _ROW_TILE) * -(-n // bn)
        for splits in range(1, min(ktiles, -(-4 * SM_COUNT // tiles)) + 1):
            per_item = -(-ktiles // splits) + (_SPLIT_COST if splits > 1 else 0)
            cost = -(-tiles * splits // SM_COUNT) * per_item * (bn + _TILE_COST)
            if best is None or (cost, splits, -bn) < best[0]:
                best = ((cost, splits, -bn), bn, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=64)
def mlp_bwd_plan(n: int, c: int, f: int) -> dict:
    """The backward kernels' tiles for n tokens of width C and hidden F: the
    column tiles (64 or 128) of fc1 recomputed (``bn_h``), of dH (``bn_dh``)
    and of dxn (``bn_dx``) by ``_column_tile``'s rule, and of the weight
    gradients dW2 (C, F) and dW1 (F, C) with their split-K factors over the
    tokens (``bn_dw2``, ``splits_dw2``, ``bn_dw1``, ``splits_dw1``) by
    ``_split_k``'s. Cached: the backward asks for it at every call (the
    returned dict is shared, not to be changed)."""
    bn_dw2, splits_dw2 = _split_k(c, f, n)
    bn_dw1, splits_dw1 = _split_k(f, c, n)
    return {"bn_h": _column_tile(n, f, _BWD_TILES), "bn_dh": _column_tile(n, f, _BWD_TILES),
            "bn_dx": _column_tile(n, c, _BWD_TILES), "bn_dw2": bn_dw2,
            "splits_dw2": splits_dw2, "bn_dw1": bn_dw1, "splits_dw1": splits_dw1}


def mlp_plan(n: int, c: int, f: int) -> dict:
    """The kernel's tiles for n tokens of width C and hidden F: fc1's and
    fc2's column tiles (``bn1``, ``bn2``) and output tiles (``tiles1``,
    ``tiles2``). The GEMM kernel is persistent: it launches min(tiles, the
    CTAs the card holds at once) CTAs, so at least 132 tiles put a CTA on
    every SM of the H100."""
    bn1, bn2 = _column_tile(n, f), _column_tile(n, c)
    rows = -(-n // _ROW_TILE)
    return {"bn1": bn1, "bn2": bn2, "tiles1": rows * -(-f // bn1),
            "tiles2": rows * -(-c // bn2)}


def _check_operands(name: str, x, **ops) -> None:
    """Raise unless x and the named weights are what the kernels take."""
    c = x.shape[-1]
    f = ops["w1"].shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    shapes = {"scale": (c,), "bias": (c,), "w1": (f, c), "b1": (f,),
              "w2": (c, f), "b2": (c,)}
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bf16, got {x.dtype}")
    for key, t in ops.items():
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shapes[key]
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be contiguous bf16 "
                             f"{shapes[key]} on {x.device}")
    if c % 16 or f % 16:
        raise ValueError(f"{name}: C={c}, F={f} (multiples of 16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *ops.values())):
        raise ValueError(f"{name}: operands must be 16-byte aligned (TMA)")


def _ln_mlp_kernel(x, scale, bias, w1, b1, w2, b2, eps: float,
                   add_residual: bool) -> torch.Tensor:
    c = x.shape[-1]
    f = w1.shape[0]
    _check_operands("fused_ln_mlp", x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2, b2=b2)
    out = torch.empty_like(x)
    n = x.numel() // c
    if n == 0:
        return out
    plan = mlp_plan(n, c, f)
    xn = torch.empty((n, c), dtype=x.dtype, device=x.device)
    hidden = torch.empty((n, f), dtype=x.dtype, device=x.device)
    launch("pd_fused_ln_mlp", x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
           xn.data_ptr(), hidden.data_ptr(), n, c, f, float(eps), int(add_residual),
           plan["bn1"], plan["bn2"])
    count("fused_ln_mlp")
    return out


def fused_ln_mlp_backward(grad, x, scale, bias, w1, b1, w2, eps: float = 1e-5,
                          add_residual: bool = True, needs=(True,) * 7) -> tuple:
    """The gradients (dx, dscale, dbias, dw1, db1, dw2, db2) of
    ``fused_ln_mlp(x, scale, bias, w1, b1, w2, b2, eps, add_residual)`` at
    ``grad`` = d out, by the backward kernels (``csrc/fused_mlp_bwd.cu``); a
    gradient whose entry in ``needs`` is false is not computed and is None.
    CUDA tensors as the forward kernel takes them; ``grad`` bf16 of x's shape.
    One call counts as one launch of ``fused_ln_mlp_backward``
    (``ops/autograd.LAUNCHES``)."""
    c = x.shape[-1]
    f = w1.shape[0]
    _check_operands("fused_ln_mlp_backward", x, scale=scale, bias=bias, w1=w1, b1=b1, w2=w2)
    if grad.dtype != torch.bfloat16 or grad.shape != x.shape or grad.device != x.device:
        raise ValueError(f"fused_ln_mlp_backward: grad must be bf16 {tuple(x.shape)} on "
                         f"{x.device}, got {grad.dtype} {tuple(grad.shape)}")
    grad = grad.contiguous()
    n = x.numel() // c
    need = dict(zip(_GRADS, needs))
    shapes = {"x": x.shape, "scale": (c,), "bias": (c,), "w1": (f, c), "b1": (f,),
              "w2": (c, f), "b2": (c,)}
    if n == 0:
        return tuple(x.new_zeros(shapes[k]) if need[k] else None for k in _GRADS)
    plan = mlp_bwd_plan(n, c, f)
    # db2 comes from the dxn product's epilogue, with dscale and dbias
    need_dxn = need["x"] or need["scale"] or need["bias"] or need["b2"]
    need_dpre = need_dxn or need["w1"] or need["b1"]
    need_h = need_dpre or need["w2"]

    def empty(cond, *shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=x.device) if cond else None

    f32 = torch.float32
    dx = empty(need["x"], *x.shape)
    dw1, db1, dw2 = empty(need["w1"], f, c), empty(need["b1"], f), empty(need["w2"], c, f)
    daff = empty(need["scale"] or need["bias"] or need["b2"], 3, c)
    # the split-K slices of a weight gradient taken in more than one split
    splits = max(plan["splits_dw2"] if need["w2"] else 1, plan["splits_dw1"] if need["w1"] else 1)
    scratch = {
        "xn": empty(need_h, n, c), "stats": empty(need_h, 2 * n, dtype=f32),
        "h": empty(need_h, n, f), "pre": empty(need_h, n, f, dtype=f32),
        "dpre": empty(need_dpre, n, f), "dxn": empty(need["x"], n, c, dtype=f32),
        "ws": empty(splits > 1, splits * c * f, dtype=f32),
        "part_b1": empty(need_dpre, -(-n // _ROW_TILE), f, dtype=f32),
        "part_rows": empty(need_dxn, -(-n // _ROW_TILE), 3 * c, dtype=f32)}
    flags = sum(1 << i for i, k in enumerate(_GRADS) if need[k])
    flags |= _RESIDUAL if add_residual else 0

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    launch("pd_fused_ln_mlp_bwd", x.device,
           x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(), b1.data_ptr(),
           w2.data_ptr(), grad.data_ptr(), ptr(dx), ptr(dw1), ptr(db1), ptr(dw2), ptr(daff),
           *[ptr(t) for t in scratch.values()], n, c, f, float(eps), flags, plan["bn_h"],
           plan["bn_dh"], plan["bn_dx"], plan["bn_dw2"], plan["splits_dw2"], plan["bn_dw1"],
           plan["splits_dw1"])
    count("fused_ln_mlp_backward")
    daff = (None, None, None) if daff is None else daff.unbind(0)
    out = {"x": dx, "scale": daff[0], "bias": daff[1], "w1": dw1, "b1": db1, "w2": dw2,
           "b2": daff[2]}
    return tuple(out[k] if need[k] else None for k in _GRADS)


def ln_mlp_bwd_plain(grad, x, scale, bias, w1, b1, w2, eps: float = 1e-5,
                     add_residual: bool = True, rounded: tuple = ()) -> tuple:
    """The backward kernels' algorithm in PyTorch, their reference on the
    card (``chip_smoke.py``, ``tests/test_torch_mlp_bwd_cuda.py``): the
    gradients (dx, dscale, dbias, dw1, db1, dw2, db2) of
    ``ln_mlp_kernel_numerics`` at ``grad``, with one-pass f32 LayerNorm
    statistics, bf16 (x.dtype) product operands xn, h, grad, dpre and the
    weights with f32 accumulation, f32 GELU', column sums and LayerNorm
    backward, and each gradient rounded to x.dtype once. Only the order of
    the f32 sums differs from the kernels'. ``rounded`` names f32 values
    ("pre", "dxn") to round to x.dtype as well, as a kernel that stored them
    so would: the control that a check against this function sees it."""
    dt, c = x.dtype, x.shape[-1]
    xf, gf = x.reshape(-1, c).float(), grad.reshape(-1, c).to(dt).float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + eps)
    xh = (xf - mean) * rstd
    xn = (xh * scale.float() + bias.float()).to(dt).float()
    pre = xn @ w1.float().t() + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    h = (pre * cdf).to(dt).float()
    if "pre" in rounded:
        pre = pre.to(dt).float()
        cdf = 0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
    dpre = (gf @ w2.float()) * (cdf + pre * torch.exp(-0.5 * pre * pre) / math.sqrt(2 * math.pi))
    dpre_b = dpre.to(dt).float()
    dxn = dpre_b @ w1.float()
    if "dxn" in rounded:
        dxn = dxn.to(dt).float()
    dxh = dxn * scale.float()
    dx = rstd * (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True))
    if add_residual:
        dx = dx + gf
    grads = (dx.reshape(x.shape), (dxn * xh).sum(0), dxn.sum(0), dpre_b.t() @ xn, dpre.sum(0),
             gf.t() @ h, gf.sum(0))
    return tuple(t.to(dt) for t in grads)
