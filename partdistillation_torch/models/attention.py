"""Attention building blocks: multi-head attention with a boolean blocking
mask and the MSDeformAttn layer around the ``ops.ms_deform_attn`` sampling.

Counterpart of the JAX package's ``models/attention.py``. Parameter names
follow ``torch.nn.MultiheadAttention`` (``in_proj_weight`` packs q, k, v) and
Deformable-DETR's MSDeformAttn.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.fused_attention import fused_masked_attention
from ..ops.ms_deform_attn import ms_deform_attn
from .layers import Dense, normal_, scalar_like, zeros_

__all__ = ["MultiHeadAttention", "MSDeformAttn"]


class MultiHeadAttention(nn.Module):
    """MHA with an optional boolean ``block_mask`` (True = the pair may NOT
    attend), shape (B, 1|H, Q, K). Softmax in f32. ``use_fused`` routes
    through the masked-attention kernel (the decoder's cross-attention)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 use_fused: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.compute_dtype = dtype
        self.use_fused = use_fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def reset_parameters_with(self, g: torch.Generator):
        normal_(self.in_proj_weight, g, std=1.0 / math.sqrt(self.dim), truncate=True)
        zeros_(self.in_proj_bias)

    def forward(self, query, key, value, block_mask: Optional[torch.Tensor] = None):
        b, q, _ = query.shape
        heads, hd, d = self.num_heads, self.dim // self.num_heads, self.compute_dtype
        ws = self.in_proj_weight.to(d).chunk(3)
        bs = self.in_proj_bias.to(d).chunk(3)

        def split(x, i):
            y = torch.nn.functional.linear(x.to(d), ws[i], bs[i])
            return y.reshape(b, -1, heads, hd).transpose(1, 2)

        qh = split(query, 0)
        qh = qh * scalar_like(hd ** -0.5, qh)
        kh, vh = split(key, 1), split(value, 2)
        if self.use_fused:
            mask = None
            if block_mask is not None:
                mask = block_mask.expand((b,) + tuple(block_mask.shape[-3:]))
            out = fused_masked_attention(qh.contiguous(), kh.contiguous(),
                                         vh.contiguous(), mask)
        else:
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            if block_mask is not None:
                logits = logits.masked_fill(block_mask, -1e9)
            attn = torch.softmax(logits, dim=-1).to(d)
            out = torch.matmul(attn, vh)
        return self.out_proj(out.transpose(1, 2).reshape(b, q, self.dim))


def _sampling_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Rotated-grid bias: head h points along angle 2*pi*h/H, point p scaled by
    (p+1); normalised so that max |coord| = 1."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (encoder self-attention). ``msda_mode``
    and the band arguments select the sampling function
    (``ops.ms_deform_attn``): dense by default, or ``banded``, exact while
    the taps stay within ``band_radius`` level pixels of their reference
    points (``msda_band_oob_fraction`` measures it)."""

    def __init__(self, dim: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, dtype=torch.float32, msda_mode: Optional[str] = None,
                 band_radius: int = 6, band_tile_queries: int = 512,
                 band_tile_x: Optional[int] = None):
        super().__init__()
        self.dim, self.n_levels, self.n_heads, self.n_points = dim, n_levels, n_heads, n_points
        self.msda_mode, self.band_radius = msda_mode, band_radius
        self.band_tile_queries, self.band_tile_x = band_tile_queries, band_tile_x
        self.value_proj = Dense(dim, dim, dtype=dtype)
        self.sampling_offsets = Dense(dim, n_heads * n_levels * n_points * 2, dtype=dtype)
        self.attention_weights = Dense(dim, n_heads * n_levels * n_points, dtype=dtype)
        self.output_proj = Dense(dim, dim, dtype=dtype)

    def reset_parameters_with(self, g: torch.Generator):
        bias = _sampling_offset_bias(self.n_heads, self.n_levels, self.n_points)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.as_tensor(bias))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def sampling(self, query, reference_points, spatial_shapes: Sequence[Tuple[int, int]]):
        """The sampling locations (B, Lq, M, L, P, 2) and attention weights
        (B, Lq, M, L, P) that ``query`` predicts."""
        b, lq, _ = query.shape
        m, L, p = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(b, lq, m, L, p, 2)
        weights = self.attention_weights(query).reshape(b, lq, m, L * p)
        weights = torch.softmax(weights, dim=-1).reshape(b, lq, m, L, p)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[None, None, None, :, None, :])
        return locations, weights

    def forward(self, query, reference_points, value_flatten,
                spatial_shapes: Sequence[Tuple[int, int]]):
        """query (B, Lq, C); reference_points (B, Lq, L, 2) in [0, 1];
        value_flatten (B, S, C)."""
        b = query.shape[0]
        value = self.value_proj(value_flatten).reshape(b, -1, self.n_heads,
                                                        self.dim // self.n_heads)
        locations, weights = self.sampling(query, reference_points, spatial_shapes)
        out = ms_deform_attn(value, tuple(spatial_shapes), locations, weights,
                             mode=self.msda_mode, band_radius=self.band_radius,
                             band_tile_queries=self.band_tile_queries,
                             band_tile_x=self.band_tile_x)
        return self.output_proj(out)
