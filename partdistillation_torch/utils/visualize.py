"""Visualization: mask overlays and the collage maker.

The port's own copy of the JAX package's ``utils/visualize.py`` (numpy and
PIL only), the reference's ``Partvisualizer`` (part masks as coloured
overlays with white contours) and its collage CLI (grids of image / GT /
prediction panels). The same inputs give the same bytes in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["color_palette", "overlay_masks", "make_collage", "save_image"]


def color_palette(n: int, seed: int = 7) -> np.ndarray:
    """(n, 3) uint8 distinct-ish colors (golden-ratio hue walk)."""
    import colorsys

    rng = np.random.RandomState(seed)
    hues = (np.arange(n) * 0.61803398875 + rng.rand()) % 1.0
    cols = [colorsys.hsv_to_rgb(h, 0.85, 0.95) for h in hues]
    return (np.asarray(cols) * 255).astype(np.uint8)


def _contour(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a bool mask (4-neighborhood erosion difference)."""
    interior = mask.copy()
    interior[1:] &= mask[:-1]
    interior[:-1] &= mask[1:]
    interior[:, 1:] &= mask[:, :-1]
    interior[:, :-1] &= mask[:, 1:]
    return mask & ~interior


def overlay_masks(
    image: np.ndarray,
    masks: np.ndarray,
    valid: Optional[np.ndarray] = None,
    labels: Optional[Sequence[int]] = None,
    alpha: float = 0.55,
    draw_contours: bool = True,
) -> np.ndarray:
    """image (H,W,3) uint8/float + masks (T,H,W) bool -> overlay uint8.

    Colors are keyed by ``labels`` when given (consistent colors per part
    class across images), else by mask index.
    """
    img = np.asarray(image, np.float32).copy()
    if img.max() <= 1.0:
        img *= 255.0
    t = masks.shape[0]
    keys = list(labels) if labels is not None else list(range(t))
    palette = color_palette(max(keys) + 1 if keys else 1)
    for i in range(t):
        if valid is not None and not valid[i]:
            continue
        m = masks[i].astype(bool)
        if not m.any():
            continue
        color = palette[keys[i] % len(palette)].astype(np.float32)
        img[m] = (1 - alpha) * img[m] + alpha * color
        if draw_contours:
            img[_contour(m)] = 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def make_collage(panels: List[np.ndarray], cols: int = 4,
                 pad: int = 2, pad_value: int = 255) -> np.ndarray:
    """List of (H,W,3) uint8 panels -> grid collage (row-major)."""
    if not panels:
        raise ValueError("make_collage: no panels")
    h = max(p.shape[0] for p in panels)
    w = max(p.shape[1] for p in panels)
    norm = []
    for p in panels:
        canvas = np.full((h, w, 3), pad_value, np.uint8)
        canvas[: p.shape[0], : p.shape[1]] = p
        norm.append(canvas)
    rows = (len(norm) + cols - 1) // cols
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3),
                   pad_value, np.uint8)
    for i, p in enumerate(norm):
        r, c = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (w + pad): c * (w + pad) + w] = p
    return grid


def save_image(path: str, array: np.ndarray):
    from PIL import Image

    Image.fromarray(array).save(path)
