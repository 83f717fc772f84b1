"""Cityscapes Panoptic-Parts dataset: object + part instances from part PNGs.

The port's own copy of the JAX package's ``data/datasets/cityscapes_part.py``
(the reference's ``register_cityscapes_part.py``): the panoptic-parts label
images decode into object instances of the five human / vehicle semantic ids
{24 person, 25 rider, 26 car, 27 truck, 28 bus} and their part instances.

Panoptic-parts encoding (public spec): each pixel holds an integer ``uid``:
  * ``uid < 100``                      -> semantic id only (no instance)
  * ``100 <= uid < 100_000``           -> sid * 1000 + iid
  * ``uid >= 100_000``                 -> (sid * 1000 + iid) * 100 + pid
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..catalog import Metadata

__all__ = ["decode_panoptic_parts", "load_cityscapes_part", "cityscapes_part_metadata",
           "CITYSCAPES_PART_SIDS"]

CITYSCAPES_PART_SIDS: Dict[int, str] = {
    24: "person", 25: "rider", 26: "car", 27: "truck", 28: "bus",
}

# Global part-label offsets per semantic id, so part ids from different object
# classes don't collide in one confusion matrix (the reference's PART_BASE_ID,
# cityscapes_part_mapper.py:35,74): person/rider have 4 parts each,
# car/truck/bus 5 each -> 23 global part classes.
CITYSCAPES_PART_BASE: Dict[int, int] = {24: 0, 25: 4, 26: 8, 27: 13, 28: 18}
CITYSCAPES_NUM_PART_CLASSES = 23


def decode_panoptic_parts(uids: np.ndarray, keep_sids=tuple(CITYSCAPES_PART_SIDS)) -> List[dict]:
    """uid image -> [{sid, iid, object_mask, parts: [{pid, mask}]}]."""
    uids = uids.astype(np.int64)
    sid = np.where(uids < 100, uids,
                   np.where(uids < 100_000, uids // 1000, uids // 100_000))
    iid = np.where(uids < 100, -1,
                   np.where(uids < 100_000, uids % 1000, (uids // 100) % 1000))
    pid = np.where(uids >= 100_000, uids % 100, -1)

    objects: List[dict] = []
    for s in keep_sids:
        sel = sid == s
        if not sel.any():
            continue
        for i in np.unique(iid[sel]):
            if i < 0:
                continue
            obj_mask = sel & (iid == i)
            parts = []
            for p in np.unique(pid[obj_mask]):
                if p <= 0:
                    continue
                parts.append({"pid": int(p), "mask": obj_mask & (pid == p)})
            objects.append({
                "sid": int(s), "iid": int(i),
                "class_name": CITYSCAPES_PART_SIDS.get(int(s), str(s)),
                "object_mask": obj_mask, "parts": parts,
            })
    return objects


def load_cityscapes_part(
    part_label_dir: str,
    image_dir: str,
    split: str = "val",
    debug_limit: Optional[int] = None,
) -> List[dict]:
    """Items: {image_id, file_name, part_png} — decode is deferred to the
    mapper (PNGs are 2MP; eager decode of 500 val images would be fine, but
    the lazy contract matches the other loaders)."""
    label_root = os.path.join(part_label_dir, split)
    image_root = os.path.join(image_dir, split)
    items: List[dict] = []
    if not os.path.isdir(label_root):
        return items
    for city in sorted(os.listdir(label_root)):
        city_dir = os.path.join(label_root, city)
        for fname in sorted(os.listdir(city_dir)):
            if not fname.endswith(".png") and not fname.endswith(".tif"):
                continue
            stem = fname.rsplit("_", 1)[0].replace("_gtFinePanopticParts", "")
            image_id = stem
            img_path = os.path.join(image_root, city, stem + "_leftImg8bit.png")
            items.append({
                "image_id": image_id,
                "file_name": img_path,
                "part_png": os.path.join(city_dir, fname),
            })
            if debug_limit and len(items) >= debug_limit:
                return items
    return items


def cityscapes_part_metadata(name: str = "cityscapes_part") -> Metadata:
    return Metadata(
        name=name,
        class_names=[CITYSCAPES_PART_SIDS[s] for s in sorted(CITYSCAPES_PART_SIDS)],
        extra={"sids": sorted(CITYSCAPES_PART_SIDS)},
    )
