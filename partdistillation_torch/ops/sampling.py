"""Bilinear sampling for the point-sampled mask losses.

Counterpart of the JAX package's ``ops/sampling.py`` (``point_sample``,
``separable_interp_weights``, ``grid_point_sample``): torch ``grid_sample``
semantics with ``align_corners=False`` and zero padding, images channel-last.
``grid_point_sample`` samples a separable coordinate grid as two small dense
products (the interpolation matrices have two non-zeros per row) instead of
per-point gathers. Here both also take leading batch axes, so the criterion
and the matcher sample every matched pair or image in one call.
"""

from __future__ import annotations

import torch

__all__ = ["point_sample", "separable_interp_weights", "grid_point_sample"]


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     batch_dims: int = 0) -> torch.Tensor:
    """img (*N, H, W, C) at pixel-space coordinates x, y of one shape
    (*N, *S) (0 = the centre of the first pixel), N the first ``batch_dims``
    axes of both; out-of-range taps read zero. -> (*N, *S, C)."""
    h, w, c = img.shape[-3:]
    lead = img.shape[:batch_dims]
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = img.reshape(*lead, h * w, c)

    def tap(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        if batch_dims:
            flat_idx = idx.reshape(*lead, -1, 1).expand(*lead, -1, c)
            vals = torch.gather(flat, batch_dims, flat_idx).reshape(*idx.shape, c)
        else:
            vals = flat[idx.reshape(-1)].reshape(*idx.shape, c)
        return vals * (wgt * valid.to(img.dtype))[..., None]

    return (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))


def point_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """detectron2 ``point_sample``: img (*N, H, W, C), coords (*N, ..., 2) as
    (x, y) in [0, 1] -> (*N, ..., C); each of the N leading images is
    sampled at its own coordinates."""
    h, w = img.shape[-3], img.shape[-2]
    grid = 2.0 * coords - 1.0
    x = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    return _bilinear_sample(img, x, y, img.dim() - 3)


def separable_interp_weights(coords_1d: torch.Tensor, size: int) -> torch.Tensor:
    """(..., G) coordinates in [0, 1] -> (..., G, size) hat-function weights
    ``max(0, 1 - |p - s|)`` with p = coord * size - 0.5."""
    p = coords_1d * size - 0.5
    s = torch.arange(size, dtype=p.dtype, device=p.device)
    return torch.clamp(1.0 - (p[..., None] - s).abs(), min=0.0)


def grid_point_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (..., H, W, C) on the grid ys (..., Gy) x
    xs (..., Gx) -> (..., Gy, Gx, C), equal to ``point_sample`` at the outer
    product of the coordinates. Interpolation weights and the intermediate
    are rounded to img's dtype, products accumulate in f32."""
    h, w = img.shape[-3], img.shape[-2]
    wy = separable_interp_weights(ys, h).to(img.dtype)
    wx = separable_interp_weights(xs, w).to(img.dtype)
    tmp = torch.einsum("...gh,...hwc->...gwc", wy.float(), img.float()).to(img.dtype)
    out = torch.einsum("...kw,...gwc->...gkc", wx.float(), tmp.float())
    return out.to(img.dtype)
