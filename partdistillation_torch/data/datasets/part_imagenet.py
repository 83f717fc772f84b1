"""PartImageNet dataset (COCO-json part annotations over ImageNet images).

The port's own copy of the JAX package's ``data/datasets/part_imagenet.py``:
loads a COCO-format json, groups part annotations per image, supports
``label_percentage`` subsetting with the fixed seed 1234 of the fewshot
ablations, and carries each image's object synset code. No pycocotools: RLE
segmentations decode through ``utils/rle.py`` and polygons rasterize through
PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..catalog import Metadata

__all__ = ["load_part_imagenet", "part_imagenet_metadata", "ann_to_mask"]


def ann_to_mask(ann: dict, height: int, width: int) -> np.ndarray:
    """COCO segmentation (RLE dict or polygon list) -> bool mask."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        from ...utils import rle as rle_codec

        return rle_codec.decode(seg).astype(bool)
    from PIL import Image, ImageDraw

    img = Image.new("1", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, dtype=bool)


def load_part_imagenet(
    json_file: str,
    image_root: str,
    label_percentage: Optional[float] = None,
    subset_seed: int = 1234,
    debug_limit: Optional[int] = None,
) -> List[dict]:
    """Items: {image_id, file_name, height, width, class_code, annotations}.

    ``annotations`` is the list of raw COCO part anns for the image (each has
    ``category_id`` and ``segmentation``); the object synset code is derived
    from the file name prefix (PartImageNet images are named
    ``<synset>_<n>.JPEG``).
    """
    with open(json_file) as f:
        coco = json.load(f)

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    items: List[dict] = []
    for img in coco.get("images", []):
        fname = img["file_name"]
        code = os.path.basename(fname).split("_")[0]
        items.append({
            "image_id": str(img["id"]),
            "file_name": os.path.join(image_root, fname),
            "height": img["height"],
            "width": img["width"],
            "class_code": code,
            "annotations": anns_by_image.get(img["id"], []),
        })

    if label_percentage is not None and label_percentage < 100.0:
        rng = np.random.RandomState(subset_seed)
        n = max(1, int(round(len(items) * label_percentage / 100.0)))
        keep = rng.permutation(len(items))[:n]
        items = [items[i] for i in sorted(keep)]

    if debug_limit:
        items = items[:debug_limit]
    return items


def part_imagenet_metadata(json_file: str, name: str = "part_imagenet") -> Metadata:
    with open(json_file) as f:
        coco = json.load(f)
    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    return Metadata(
        name=name,
        part_class_names=[c["name"] for c in cats],
        extra={"category_ids": [c["id"] for c in cats]},
    )
