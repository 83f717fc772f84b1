"""Row LayerNorm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain version.

Counterpart of the JAX package's ``ops/layer_norm.py``: statistics in f32
whatever the input dtype (two-pass: mean, then mean of centred squares), f32
affine, output in the input dtype. On CUDA the gradient is the VJP of the
plain version (``ops/autograd.route``), as the JAX package's ``custom_vjp``.
``layer_norm_plan`` chooses the kernel's geometry, which the launch takes.
"""

from __future__ import annotations

import functools

import torch

from ..utils.native_lib import launch
from .autograd import count, route

__all__ = ["fused_layer_norm", "layer_norm_plain", "layer_norm_plan"]

# the 16-byte chunks a lane may hold (the kernel's instances: at most 96 f32
# values of a row in a lane's registers)
_LN_LOADS = {torch.bfloat16: (1, 2, 3, 4, 6, 8, 12),
             torch.float32: (1, 2, 3, 4, 6, 8, 12, 16, 24)}
_LN_LOADS_IN_FLIGHT = 3  # the chunks a lane aims to hold


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=256)
def layer_norm_plan(rows: int, c: int, dtype: torch.dtype, aligned: bool) -> dict:
    """The kernel's geometry for ``rows`` rows of width ``c`` in ``dtype``
    (bf16 or f32); ``aligned``: x, out, scale and bias 16-byte aligned.

    The vector variant when C is a multiple of a 16-byte chunk (8 bf16, 4
    f32) and the bases are aligned: ``lanes`` lanes per row, the least power
    of two up to 32 that leaves each lane about three chunks, and ``loads``
    chunks per lane (rounded up to an instance of the kernel), several rows
    per warp where C is narrow. Otherwise, or where a row does not fit in
    the registers, the scalar variant (``loads`` 0): one warp per row.
    Cached: the wrapper asks once per call; callers must not mutate it."""
    vec = 16 // dtype.itemsize
    chunks = c // vec
    if aligned and c % vec == 0 and chunks > 0:
        lanes = 1
        while lanes < 32 and lanes * _LN_LOADS_IN_FLIGHT < chunks:
            lanes *= 2
        need = -(-chunks // lanes)
        loads = next((k for k in _LN_LOADS[dtype] if k >= need), 0)
        if loads:
            return {"lanes": lanes, "loads": loads}
    return {"lanes": 32, "loads": 0}


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (bf16 or f32) with f32 affine
    parameters ``scale``/``bias``. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    return route("layer_norm", layer_norm_plain, _layer_norm_kernel, x, scale, bias, eps=eps)


def _layer_norm_kernel(x, scale, bias, eps: float) -> torch.Tensor:
    c = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_layer_norm: x dtype {x.dtype} (bf16 or f32)")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device:
            raise ValueError(f"fused_layer_norm: {name} must be f32 ({c},) on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("fused_layer_norm: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    if rows == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, bias, out))
    plan = layer_norm_plan(rows, c, x.dtype, aligned)
    launch("pd_layer_norm", x.device, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           out.data_ptr(), rows, c, float(eps), int(x.dtype == torch.bfloat16), plan["lanes"],
           plan["loads"])
    count("layer_norm")
    return out
