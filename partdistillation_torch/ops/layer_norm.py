"""Row LayerNorm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain version.

Counterpart of the JAX package's ``ops/layer_norm.py``: statistics in f32
whatever the input dtype (two-pass: mean, then mean of centred squares), f32
affine, output in the input dtype. On CUDA the gradient is the VJP of the
plain version (``ops/autograd.py``), as the JAX package's ``custom_vjp``.
"""

from __future__ import annotations

import functools

import torch

from ..utils.native_lib import check, load_library
from .autograd import kernel_with_plain_vjp

__all__ = ["fused_layer_norm", "layer_norm_plain"]


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


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (bf16 or f32) with f32 affine
    parameters ``scale``/``bias``. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    return kernel_with_plain_vjp(functools.partial(_layer_norm_kernel, eps=eps),
                                 functools.partial(layer_norm_plain, eps=eps),
                                 x, scale, bias)


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
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.pd_layer_norm(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                           out.data_ptr(), rows, c, float(eps),
                           int(x.dtype == torch.bfloat16), stream)
    fused_layer_norm.launches += 1
    check(rc, "pd_layer_norm")
    return out


fused_layer_norm.launches = 0
