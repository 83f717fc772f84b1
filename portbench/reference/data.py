"""Plain mappers from the written image set to the rows a training step
takes, from the dataset's published format: the reference's own inputs.

``part_imagenet`` (PartImageNet's COCO json and JPEGs): the image decoded to
RGB and resized to S x S (bilinear); each part polygon filled at the image's
own size, resized to S x S (nearest), and the parts of one class joined into
one mask, classes in increasing order; up to ``capacity`` masks, a slot valid
where its mask has a pixel, its label the part class.

A store kind names its mapper here as its ``REFERENCE`` (``stores/``); one
with none has its rows taken as the loader made them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def _polygon_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    canvas = Image.new("1", (w, h), 0)
    draw = ImageDraw.Draw(canvas)
    for poly in polys:
        pts = list(zip(poly[0::2], poly[1::2]))
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(canvas, dtype=bool)


class PartImageNet:
    """Rows of image ids from ``paths['part_json']`` and
    ``paths['imagenet_root']``."""

    def __init__(self, paths: Dict[str, str], size: int, capacity: int):
        with open(paths["part_json"]) as f:
            coco = json.load(f)
        self.root, self.size, self.capacity = paths["imagenet_root"], size, capacity
        self.images = {str(im["id"]): im for im in coco["images"]}
        self.anns: Dict[str, list] = {}
        for a in coco["annotations"]:
            self.anns.setdefault(str(a["image_id"]), []).append(a)

    def row(self, image_id: str) -> Dict[str, np.ndarray]:
        from PIL import Image

        rec, s = self.images[image_id], self.size
        with Image.open(os.path.join(self.root, rec["file_name"])) as im:
            image = np.asarray(im.convert("RGB").resize((s, s), Image.BILINEAR))
        by_class: Dict[int, np.ndarray] = {}
        for a in self.anns.get(image_id, []):
            m = _polygon_mask(a["segmentation"], rec["height"], rec["width"])
            m = np.asarray(Image.fromarray(m.astype(np.uint8)).resize((s, s), Image.NEAREST),
                           bool)
            cid = int(a["category_id"])
            by_class[cid] = by_class.get(cid, np.zeros((s, s), bool)) | m
        masks = np.zeros((self.capacity, s, s), bool)
        labels = np.zeros(self.capacity, np.int64)
        for i, cid in enumerate(sorted(by_class)[:self.capacity]):
            masks[i], labels[i] = by_class[cid], cid
        return {"image": image, "masks": masks, "valid": masks.any(axis=(1, 2)),
                "labels": labels}

    def batch(self, image_ids) -> Dict[str, np.ndarray]:
        rows = [self.row(str(i)) for i in image_ids]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
