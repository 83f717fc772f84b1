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
of the wrapper; ``mlp_plan`` chooses each GEMM's column tile. The gradient is
the VJP of ``ln_mlp_kernel_numerics`` recomputed from the saved inputs
(``ops/autograd.py``), as the JAX package's ``custom_vjp``.
"""

from __future__ import annotations

import functools

import torch

from ..utils.native_lib import SM_COUNT, check, load_library
from .autograd import kernel_with_plain_vjp

__all__ = ["fused_ln_mlp", "ln_mlp_kernel_numerics", "ln_mlp_reference", "mlp_plan"]

# the GEMM kernel's row tile, its column tiles, and a tile's fixed cost in
# columns' worth of work
_ROW_TILE, _COLUMN_TILES, _TILE_COST = 128, (128, 96, 64), 32


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
    if x.device.type == "cpu":
        return ln_mlp_kernel_numerics(x, scale, bias, w1, b1, w2, b2, eps,
                                      add_residual)
    kw = dict(eps=eps, add_residual=add_residual)
    return kernel_with_plain_vjp(functools.partial(_ln_mlp_kernel, **kw),
                                 functools.partial(ln_mlp_kernel_numerics, **kw),
                                 x, scale, bias, w1, b1, w2, b2, name="ln_mlp")


def _column_tile(m: int, n: int) -> int:
    """The kernel's column tile (128, 96 or 64) that gives the busiest SM the
    least work: rounds of two resident CTAs per SM times the tile's width plus
    a fixed per-tile cost worth 32 columns; ties go to the wider tile. On the
    H100 its choice is within 1 % of the fastest tile for six of the eight
    main-path GEMMs and within 7 % for the other two
    (``tools/torch_kernel_breakdown.py --tiles``, PERF.md)."""
    rows = -(-m // _ROW_TILE)

    def cost(bn):
        return -(-rows * -(-n // bn) // (2 * SM_COUNT)) * (bn + _TILE_COST)

    return min(_COLUMN_TILES, key=lambda bn: (cost(bn), -bn))


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


def _ln_mlp_kernel(x, scale, bias, w1, b1, w2, b2, eps: float,
                   add_residual: bool) -> torch.Tensor:
    c = x.shape[-1]
    f = w1.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp: unsupported device {x.device}")
    shapes = {"scale": (c,), "bias": (c,), "w1": (f, c), "b1": (f,),
              "w2": (c, f), "b2": (c,)}
    ops = {"scale": scale, "bias": bias, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_ln_mlp: kernel takes bf16, got {x.dtype}")
    for name, t in ops.items():
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shapes[name]
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"fused_ln_mlp: {name} must be contiguous bf16 "
                             f"{shapes[name]} on {x.device}")
    if c % 16 or f % 16:
        raise ValueError(f"fused_ln_mlp: C={c}, F={f} (multiples of 16)")
    if not x.is_contiguous():
        raise ValueError("fused_ln_mlp: x must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *ops.values())):
        raise ValueError("fused_ln_mlp: operands must be 16-byte aligned (TMA)")
    out = torch.empty_like(x)
    n = x.numel() // c
    if n == 0:
        return out
    plan = mlp_plan(n, c, f)
    xn = torch.empty((n, c), dtype=x.dtype, device=x.device)
    hidden = torch.empty((n, f), dtype=x.dtype, device=x.device)
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pd_fused_ln_mlp(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                             b2.data_ptr(), out.data_ptr(), xn.data_ptr(),
                             hidden.data_ptr(), n, c, f, float(eps), int(add_residual),
                             plan["bn1"], plan["bn2"], stream)
    fused_ln_mlp.launches += 1
    check(rc, "pd_fused_ln_mlp")
    return out


fused_ln_mlp.launches = 0
