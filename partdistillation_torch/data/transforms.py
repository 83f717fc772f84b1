"""Host-side image/mask transforms (numpy + PIL) used by the dataset mappers.

The port's own copy of the JAX package's ``data/transforms.py`` (so that
both packages build the same arrays from the same item): base resize to a
square IMAGE_SIZE, random scale jitter + fixed-size crop, horizontal flip,
with crops sampled to overlap the union of valid masks. Every function
returns fixed shapes: (size, size, 3) images and (size, size) masks. PIL is
imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["AugmentConfig", "load_image", "resize_image", "resize_mask",
           "random_augment", "apply_crop_flip"]


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    min_scale: float = 0.1
    max_scale: float = 2.0
    hflip_prob: float = 0.5
    enabled: bool = True


def load_image(path: str) -> Optional[np.ndarray]:
    """RGB uint8 (H, W, 3); None on unreadable files
    (proposal_generation_mapper.py:50-54 returns None likewise)."""
    try:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except Exception:
        return None


def resize_image(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(image).resize((size[1], size[0]), Image.BILINEAR)
    )


def resize_mask(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(mask.astype(np.uint8)).resize((size[1], size[0]), Image.NEAREST)
    ).astype(bool)


def random_augment(rng: np.random.RandomState, cfg: AugmentConfig, size: int,
                   focus_mask: Optional[np.ndarray] = None):
    """Sample (scale, crop_y, crop_x, flip) params for a size**2 output.

    When ``focus_mask`` is given, the crop window is biased to contain its
    bounding-box center so annotated content survives the crop (replacing the
    reference's 100-retry loop, proposal_dataset_mapper.py:143-167).
    """
    if not cfg.enabled:
        return 1.0, 0, 0, False
    scale = float(rng.uniform(cfg.min_scale, cfg.max_scale))
    scaled = max(int(round(size * scale)), 1)
    max_off = max(scaled - size, 0)
    if focus_mask is not None and focus_mask.any() and max_off > 0:
        ys, xs = np.nonzero(focus_mask)
        cy = int(ys.mean() / focus_mask.shape[0] * scaled)
        cx = int(xs.mean() / focus_mask.shape[1] * scaled)
        crop_y = int(np.clip(cy - size // 2, 0, max_off))
        crop_x = int(np.clip(cx - size // 2, 0, max_off))
        jitter = max(size // 4, 1)
        crop_y = int(np.clip(crop_y + rng.randint(-jitter, jitter + 1), 0, max_off))
        crop_x = int(np.clip(crop_x + rng.randint(-jitter, jitter + 1), 0, max_off))
    else:
        crop_y = int(rng.randint(0, max_off + 1))
        crop_x = int(rng.randint(0, max_off + 1))
    flip = bool(rng.rand() < cfg.hflip_prob)
    return scale, crop_y, crop_x, flip


def apply_crop_flip(arr: np.ndarray, scale: float, crop_y: int, crop_x: int,
                    flip: bool, size: int, is_mask: bool) -> np.ndarray:
    """Resize by scale, crop/pad to (size, size), optional hflip.

    The scale-up path resizes ONLY the crop window (PIL's ``box=``): the
    output sampling grid is affinely identical to resize-then-crop (same
    source-coordinate mapping, same filter ratio), but the work is always
    size^2 instead of (size*scale)^2 — at max_scale=2 this quarters the
    mapper's dominant cost (profiled 14 ms -> ~4 ms per 640^2 image)."""
    from PIL import Image

    scaled = max(int(round(size * scale)), 1)
    if scaled >= size:
        h, w = arr.shape[:2]
        box = (crop_x / scaled * w, crop_y / scaled * h,
               (crop_x + size) / scaled * w, (crop_y + size) / scaled * h)
        if is_mask:
            arr = np.asarray(
                Image.fromarray(arr.astype(np.uint8)).resize(
                    (size, size), Image.NEAREST, box=box)).astype(bool)
        else:
            arr = np.asarray(
                Image.fromarray(arr).resize((size, size), Image.BILINEAR,
                                            box=box))
    else:
        resize = resize_mask if is_mask else resize_image
        arr = resize(arr, (scaled, scaled))
        pad = [(0, size - scaled), (0, size - scaled)] + (
            [(0, 0)] if arr.ndim == 3 else []
        )
        arr = np.pad(arr, pad)
    if flip:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def pad_stack(masks: List[np.ndarray], capacity: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Stack up to `capacity` (size, size) masks; returns (masks, valid)."""
    out = np.zeros((capacity, size, size), dtype=bool)
    valid = np.zeros((capacity,), dtype=bool)
    for i, m in enumerate(masks[:capacity]):
        out[i] = m
        valid[i] = m.any()
    return out, valid
