"""PartImageNet's format: a COCO json whose annotations are part polygons
with part classes, over the ImageNet JPEGs."""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..reference.data import PartImageNet as REFERENCE  # noqa: F401


def _polygon(mask: np.ndarray) -> List[float]:
    """A convex part mask as one COCO polygon: its rows' left ends top to
    bottom, then their right ends bottom to top."""
    rows = np.nonzero(mask.any(1))[0]
    w = mask.shape[1]
    left = [(float(np.argmax(mask[r])), float(r)) for r in rows]
    right = [(float(w - np.argmax(mask[r][::-1])), float(r) + 1.0) for r in rows[::-1]]
    return [v for pt in left + right for v in pt]


def write(root: str, images: list, traffic: dict) -> dict:
    coco_images, anns = [], []
    for i, (code, name, (h, w), parts) in enumerate(images):
        coco_images.append({"id": i, "file_name": f"{code}/{name}.JPEG", "height": h,
                            "width": w})
        for m, cls in parts:
            anns.append({"id": len(anns), "image_id": i, "category_id": cls,
                         "segmentation": [_polygon(m)]})
    cats = [{"id": k, "name": f"part{k}"} for k in range(traffic["part_classes"])]
    path = os.path.join(root, "part_imagenet.json")
    with open(path, "w") as f:
        json.dump({"images": coco_images, "annotations": anns, "categories": cats}, f)
    return {"part_json": path}


def program_items(paths: dict, size: int, capacity: int, seed: int):
    """The supervised train command's items and mapper: ``PartEvalMapper``'s
    ground-truth parts under the train step's keys."""
    from partdistillation_torch.data.datasets.part_imagenet import load_part_imagenet
    from partdistillation_torch.data.mappers import PartEvalMapper

    items = load_part_imagenet(paths["part_json"], paths["imagenet_root"])
    gt = PartEvalMapper(image_size=size, capacity=capacity)

    def mapper(item):
        ex = gt(item)
        if ex is None:
            return None
        return {"image": ex["image"], "masks": ex["gt_part_masks"],
                "labels": ex["gt_part_labels"], "valid": ex["gt_valid"],
                "image_id": ex["image_id"]}
    return items, mapper
