"""Resampling weights of ``jax.image.scale_and_translate`` / ``resize``.

The port's own copy of the installed JAX's ``compute_weight_mat``
(``jax/_src/image/scale.py``): output sample j of an axis reads input i with
weight ``kernel(|(j + 0.5 - translation) / scale - 0.5 - i| / kernel_scale)``,
normalised over i, zero where the sample lies outside the input; with
``antialias`` a downsampling kernel widens by 1 / scale. No ``F.interpolate``
mode computes this: torch's ``bicubic`` uses the cubic a = -0.75 and does not
renormalise at the edges, and its ``bilinear`` does not widen when it shrinks.
The weights are applied by two f32 products (``resample``) in full f32.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from ..utils.precision import full_f32

__all__ = ["triangle_kernel", "keys_cubic_kernel", "compute_weight_mat", "resample",
           "resize"]


def triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def keys_cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def compute_weight_mat(input_size: int, output_size: int,
                       scale: Union[float, torch.Tensor], translation: Union[float, torch.Tensor],
                       kernel: Callable, antialias: bool, device=None) -> torch.Tensor:
    """(..., input_size, output_size) f32 resampling weights of one axis;
    ``scale`` and ``translation`` are floats or tensors of one batch shape."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, dtype=torch.float32, device=scale.device)
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else torch.ones_like(inv_scale)
    out_pos = torch.arange(output_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos + 0.5) * inv_scale[..., None] - (translation * inv_scale)[..., None]
                - 0.5)  # (..., out)
    in_pos = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = (sample_f[..., None, :] - in_pos[:, None]).abs() / kernel_scale[..., None, None]
    weights = kernel(x)
    total = weights.sum(-2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def resample(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Apply (..., H, h) and (..., W, w) weights to channel-last
    (..., H, W, C): (..., h, w, C) f32, as JAX's einsum over both axes at
    its highest precision."""
    with full_f32(x.device):
        y = torch.einsum("...yxc,...yi->...ixc", x.float(), wy)
        return torch.einsum("...ixc,...xj->...ijc", y, wx)


def resize(x: torch.Tensor, h: int, w: int, kernel: Callable,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of channel-last (..., H, W, C) to (..., h, w, C)
    with ``kernel`` (``triangle_kernel`` is "linear", ``keys_cubic_kernel``
    "cubic")."""
    hin, win = x.shape[-3], x.shape[-2]
    wy = compute_weight_mat(hin, h, h / hin, 0.0, kernel, antialias, x.device)
    wx = compute_weight_mat(win, w, w / win, 0.0, kernel, antialias, x.device)
    return resample(x, wy, wx)
