"""Multi-scale deformable attention sampling core, plain PyTorch gather.

Counterpart of the JAX package's ``ops/ms_deform_attn.py`` with its
``mode="take"`` semantics: for every (query, head, level, point) the per-head
value map is sampled bilinearly at a fractional location (align_corners=False,
so pixel = loc * size - 0.5; corners outside the map read zero) and the four
corner taps are summed with the attention weight folded into the corner
weights. No kernel in this slice: the JAX main path runs this op outside
Pallas (``banded``), which equals ``take`` while taps stay in its band.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["ms_deform_attn"]


def _corner_taps(x, y, h: int, w: int, wl, dtype):
    """The four bilinear corner (flat_index, weight) pairs for pixel coords
    (x, y) on an (h, w) grid with zero padding; weights folded with ``wl``."""
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    wx1 = (x - x0f).to(dtype)
    wy1 = (y - y0f).to(dtype)
    wx0 = (1.0 - (x - x0f)).to(dtype)
    wy0 = (1.0 - (y - y0f)).to(dtype)
    taps = []
    for yi, xi, wgt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                        (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        taps.append((idx, wgt * valid.to(dtype) * wl))
    return taps


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, S, M, D) with S = sum of H_l * W_l; sampling_locations
    (B, Lq, M, L, P, 2) in [0, 1], last axis (x, y); attention_weights
    (B, Lq, M, L, P). Returns (B, Lq, M * D) in value's dtype."""
    b, s, m, d = value.shape
    _, lq, _, num_levels, p, _ = sampling_locations.shape
    if num_levels != len(spatial_shapes) or s != sum(h * w for h, w in spatial_shapes):
        raise ValueError(f"value length {s} / levels {num_levels} do not match "
                         f"spatial shapes {tuple(spatial_shapes)}")
    dtype = value.dtype
    val_cf = value.permute(0, 2, 3, 1).reshape(b * m, d, s)
    loc = sampling_locations.permute(0, 2, 3, 1, 4, 5).reshape(b * m, num_levels, lq * p, 2)
    attw = attention_weights.permute(0, 2, 3, 1, 4).reshape(
        b * m, num_levels, lq * p).to(dtype)

    out = torch.zeros((b * m, d, lq), dtype=dtype, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        vl = val_cf[:, :, start:start + h * w]
        size = torch.tensor([w, h], dtype=torch.float32, device=value.device)
        xy = loc[:, lvl].float() * size - 0.5
        sampled = torch.zeros((b * m, d, lq * p), dtype=dtype, device=value.device)
        for idx, wgt in _corner_taps(xy[..., 0], xy[..., 1], h, w, attw[:, lvl], dtype):
            taps = torch.gather(vl, 2, idx[:, None, :].expand(-1, d, -1))
            sampled = sampled + taps * wgt[:, None, :]
        out = out + sampled.reshape(b * m, d, lq, p).sum(-1)
        start += h * w
    return out.reshape(b, m, d, lq).permute(0, 3, 1, 2).reshape(b, lq, m * d)
