"""ViT helpers: the patch embedding and the resized absolute positions.

Counterpart of ``PatchEmbed`` and ``get_abs_pos`` in the JAX package's
``models/vit_utils.py`` (the reference's ``modeling/backbone/utils.py``),
channel-last. The ViTDet window and relative-position helpers have no caller
in either package and are not ported (ROADMAP §1 item 9).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import keys_cubic_kernel, resize
from .layers import normal_, zeros_

__all__ = ["get_abs_pos", "PatchEmbed"]


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
