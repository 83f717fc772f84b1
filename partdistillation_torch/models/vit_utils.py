"""ViT helpers: windows, decomposed relative positions, the patch embedding
and the resized absolute positions.

Counterpart of the JAX package's ``models/vit_utils.py`` (the reference's
``modeling/backbone/utils.py``), channel-last: ``window_partition`` /
``window_unpartition``, ``get_rel_pos`` and ``add_decomposed_rel_pos`` (the
ViTDet helpers, part of the public modeling surface though no shipped
configuration calls them), ``get_abs_pos`` and ``PatchEmbed``. Resized
tables follow ``jax.image.resize``'s weights (``ops/resize.py``), not
``F.interpolate``'s.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import compute_weight_mat, keys_cubic_kernel, resize, triangle_kernel
from ..utils.precision import full_f32
from .layers import normal_, zeros_

__all__ = ["window_partition", "window_unpartition", "get_rel_pos", "add_decomposed_rel_pos",
           "get_abs_pos", "PatchEmbed"]


def window_partition(x: torch.Tensor, window_size: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> ((B * nWin, ws, ws, C), (Hp, Wp)): H and W zero-padded
    up to multiples of ``window_size``, windows image-major and row-major."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % window_size, (-w) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size, window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of ``window_partition``, cropped back to (H, W)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative-position table (L, C) at the (q_size, k_size) pairwise
    distances -> (q_size, k_size, C). A table of another length than
    2 * max(q, k) - 1 is first resized along its length as
    ``jax.image.resize(..., "linear")`` does (antialiased when it shrinks),
    in f32. The distances are scaled when the two grids differ, in f32 as
    JAX computes them, and truncated to indices."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        wm = compute_weight_mat(rel_pos.shape[0], max_rel_dist,
                                max_rel_dist / rel_pos.shape[0], 0.0, triangle_kernel, True,
                                rel_pos.device)
        with full_f32(rel_pos.device):
            rel_pos = (wm.t() @ rel_pos.float()).to(rel_pos.dtype)
    f32 = dict(dtype=torch.float32, device=rel_pos.device)
    q_coords = torch.arange(q_size, **f32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, **f32)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                           k_size: Tuple[int, int]) -> torch.Tensor:
    """Add the decomposed (axial) relative-position bias to attention logits
    (the MViTv2 scheme): attn (B, q_h*q_w, k_h*k_w), q (B, q_h*q_w, C)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)  # (q_h, k_h, C)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)  # (q_w, k_w, C)
    b = q.shape[0]
    r_q = q.reshape(b, q_h, q_w, -1)
    with full_f32(q.device):
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.reshape(b, q_h, q_w, k_h, k_w)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(b, q_h * q_w, k_h * k_w)


def get_abs_pos(abs_pos: torch.Tensor, has_cls_token: bool, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize an absolute position embedding (1, L[+1], C) to the (H, W)
    token grid -> (1, H, W, C) f32, by JAX's "bicubic" resize (Keys cubic,
    a = -0.5, weights renormalised at the edges, widened when shrinking)."""
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    num_pos = abs_pos.shape[1]
    size = int(round(num_pos ** 0.5))
    if size * size != num_pos:
        raise ValueError(f"abs_pos length {num_pos} is not square")
    grid = abs_pos.reshape(1, size, size, -1)
    if (size, size) != (h, w):
        grid = resize(grid, h, w, keys_cubic_kernel)
    return grid


class PatchEmbed(nn.Conv2d):
    """Image-to-patch embedding by a strided convolution without padding:
    (B, H, W, 3) -> (B, H', W', embed_dim), the weight (and bias) cast to
    ``dtype`` with the input."""

    def __init__(self, in_chans: int = 3, embed_dim: int = 768,
                 patch_size: Tuple[int, int] = (16, 16), stride: Tuple[int, int] = (16, 16),
                 padding: Tuple[int, int] = (0, 0), bias: bool = True, dtype=torch.float32):
        super().__init__(in_chans, embed_dim, patch_size, stride=stride, padding=padding,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        b = None if self.bias is None else self.bias.to(d)
        y = F.conv2d(x.to(d).permute(0, 3, 1, 2), self.weight.to(d), b, self.stride,
                     self.padding)
        return y.permute(0, 2, 3, 1)

    def reset_parameters_with(self, g: torch.Generator):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        normal_(self.weight, g, std=1.0 / math.sqrt(fan_in), truncate=True)
        if self.bias is not None:
            zeros_(self.bias)
