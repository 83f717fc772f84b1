"""Stage 2b's part proposal store (``paths.proposals_dcrf``: RLE part masks
per image), which the stage-3 and stage-4 mappers read."""

from __future__ import annotations

import os

import numpy as np

REFERENCE = None


def write(root: str, images: list, traffic: dict) -> dict:
    from partdistillation_torch.data.pseudo_store import ShardWriter
    from partdistillation_torch.utils import rle

    store = os.path.join(root, "proposals_dcrf")
    with ShardWriter(store, 0, 1) as writer:
        for code, name, (h, w), parts in images:
            union = np.zeros((h, w), bool)
            for m, _ in parts:
                union |= m
            writer.write({"image_id": name,
                          "part_masks": [rle.encode(m) for m, _ in parts],
                          "object_ratio": float(union.mean())})
    return {"proposals": store}


def program_items(paths: dict, size: int, capacity: int, seed: int):
    from partdistillation_torch.data.datasets.imagenet import (load_imagenet,
                                                               load_imagenet_with_proposals)
    from partdistillation_torch.data.mappers import ProposalTrainMapper

    items = load_imagenet_with_proposals(load_imagenet(paths["imagenet_root"]),
                                         paths["proposals"])
    return items, ProposalTrainMapper(image_size=size, capacity=capacity, seed=seed)
