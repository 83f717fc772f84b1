"""Dataset mappers: item dict -> fixed-shape model-input example (numpy).

The port's own copy of the stage-2 to stage-5 mappers of the JAX
package's ``data/mappers.py``, which build the same arrays from the same
item and seed (per-item ``RandomState`` seeded by (seed, crc32(image_id),
epoch)):

* ``ProposalGenerationMapper`` -- stage 2: the image and its stage-1 object
  mask;
* ``ProposalTrainMapper`` -- stage 3 training: dCRF'd part-proposal RLEs ->
  (T, S, S) masks + valid, augmented;
* ``PartRankingMapper`` -- stage 4: the image, its stage-2/3 part masks and
  their union as the object mask;
* ``PartDistillationTrainMapper`` -- stage 5 training: stage-4 part masks
  with their cluster labels and the image's object class, augmented;
* ``PartDistillationSaveMapper`` -- the stage-5 save pass: the same record
  resized without augmentation, its union as the object mask;
* ``PartEvalMapper`` -- PartImageNet evaluation: part instances (or parts
  merged per class) and their union as the object mask.

The stage-1 and supervised mappers, and ``PartEvalMapper``'s Pascal-Parts and
Cityscapes items, come with their stages (ROADMAP). Mappers return ``None``
for unusable items (unreadable image, no valid masks); the loader skips them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..utils import rle as rle_codec
from .pseudo_store import PseudoLabelStore
from .transforms import (
    AugmentConfig,
    apply_crop_flip,
    load_image,
    pad_stack,
    random_augment,
    resize_image,
    resize_mask,
)

__all__ = ["ProposalGenerationMapper", "ProposalTrainMapper", "PartRankingMapper",
           "PartDistillationTrainMapper", "PartDistillationSaveMapper", "PartEvalMapper",
           "invalidate_store_cache"]


class _StoreCache:
    """Lazy per-directory PseudoLabelStore cache shared by mappers."""

    def __init__(self):
        self._stores: Dict[str, PseudoLabelStore] = {}

    def get(self, store_dir: str) -> PseudoLabelStore:
        if store_dir not in self._stores:
            self._stores[store_dir] = PseudoLabelStore(store_dir)
        return self._stores[store_dir]


_STORES = _StoreCache()


def invalidate_store_cache(store_dir: str = None):
    """Drop cached store views so late-arriving shards/records become
    visible (one-shot stage CLIs never need it: their stores are immutable
    inputs)."""
    if store_dir is None:
        _STORES._stores.clear()
    else:
        _STORES._stores.pop(store_dir, None)


def _decode_rles(rles: List[dict]) -> List[np.ndarray]:
    return [rle_codec.decode(r).astype(bool) for r in rles]


def _item_rng(seed: int, item: dict) -> np.random.RandomState:
    """Per-item generator: the loader's thread pool calls mappers
    concurrently and np.random.RandomState is not thread-safe (a shared
    state yields correlated augmentations). Seeding by (seed, image_id,
    epoch) is thread-safe and reproducible, with fresh augmentations each
    epoch (the loader injects ``_epoch``)."""
    import zlib

    key = zlib.crc32(str(item.get("image_id", "")).encode())
    return np.random.RandomState((seed & 0xFFFFFFFF, key, item.get("_epoch", 0) & 0xFFFFFFFF))


def _stage4_record(item: dict) -> Optional[dict]:
    return _STORES.get(item["part_label_store"]).get(item["image_id"])


@dataclasses.dataclass
class ProposalGenerationMapper:
    """Stage-2 input: {image (S,S,3) f32, object_mask (S,S), image_id, class_id}."""

    image_size: int = 640

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        size = (self.image_size, self.image_size)
        image = resize_image(image, size)

        record = None
        if "object_store" in item:
            record = _STORES.get(item["object_store"]).get(item["image_id"])
        if record is None or not record.get("object_masks"):
            return None
        # the first (top-scoring) of the stage-1 record's masks
        mask = resize_mask(rle_codec.decode(record["object_masks"][0]).astype(bool), size)
        if not mask.any():
            return None
        return {
            "image": image.astype(np.float32),
            "object_mask": mask,
            "image_id": item["image_id"],
            "class_id": np.int32(item.get("class_id", 0)),
        }


@dataclasses.dataclass
class ProposalTrainMapper:
    """Stage-3 train: {image, masks (T,S,S), valid (T,)} with augmentation."""

    image_size: int = 640
    capacity: int = 8
    min_area_ratio: float = 0.0
    augment: AugmentConfig = AugmentConfig()
    seed: int = 0

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        record = item.get("proposals")
        if record is None and "proposal_store" in item:
            record = _STORES.get(item["proposal_store"]).get(item["image_id"])
        if record is None:
            return None
        masks = _decode_rles(record.get("part_masks", []))
        if not masks:
            return None

        size = self.image_size
        union = np.zeros(masks[0].shape, bool)
        for m in masks:
            union |= m
        scale, cy, cx, flip = random_augment(_item_rng(self.seed, item), self.augment, size,
                                             union)
        image = apply_crop_flip(image, scale, cy, cx, flip, size, is_mask=False)
        masks = [apply_crop_flip(m, scale, cy, cx, flip, size, is_mask=True)
                 for m in masks]
        # area-ratio filter after aug (proposal_dataset_mapper.py:228-235)
        min_px = self.min_area_ratio * size * size
        masks = [m for m in masks if m.sum() > max(min_px, 0)]
        if not masks:
            return None
        stacked, valid = pad_stack(masks, self.capacity, size)
        return {
            "image": image.astype(np.float32),
            "masks": stacked,
            "valid": valid,
            "image_id": item["image_id"],
        }


@dataclasses.dataclass
class PartRankingMapper:
    """Stage-4 input: the image, the stage-2/3 part proposals (the targets
    of the cluster and save phases' match) and their union as the object
    mask."""

    image_size: int = 640
    capacity: int = 8

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        record = item.get("proposals")
        if record is None and "proposal_store" in item:
            record = _STORES.get(item["proposal_store"]).get(item["image_id"])
        if record is None:
            return None
        masks = _decode_rles(record.get("part_masks", []))
        if not masks:
            return None
        size = (self.image_size, self.image_size)
        image = resize_image(image, size)
        masks = [resize_mask(m, size) for m in masks]
        object_mask = np.zeros(size, bool)
        for m in masks:
            object_mask |= m
        stacked, valid = pad_stack(masks, self.capacity, self.image_size)
        return {
            "image": image.astype(np.float32),
            "object_mask": object_mask,
            "part_masks": stacked,
            "part_valid": valid,
            "image_id": item["image_id"],
            "class_id": np.int32(item.get("class_id", 0)),
        }


@dataclasses.dataclass
class PartDistillationTrainMapper:
    """Stage-5 train: {image, masks (T,S,S), labels (T,), valid (T,),
    gt_object_class} with augmentation. A part is kept while it has any
    pixels, before and after the crop: JAX's defaults (``min_score`` 0, its
    scores are probabilities; ``min_area_ratio`` 0), which no CLI changes."""

    image_size: int = 640
    capacity: int = 8
    augment: AugmentConfig = AugmentConfig()
    seed: int = 0

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        record = _stage4_record(item)
        if record is None:
            return None

        masks = _decode_rles(record.get("part_masks", []))
        labels = list(record.get("part_labels", []))
        keep = [i for i, m in enumerate(masks) if m.any()]
        if not keep:
            return None
        masks = [masks[i] for i in keep]
        labels = [labels[i] for i in keep]

        size = self.image_size
        union = np.zeros(masks[0].shape, bool)
        for m in masks:
            union |= m
        scale, cy, cx, flip = random_augment(_item_rng(self.seed, item), self.augment, size,
                                             union)
        image = apply_crop_flip(image, scale, cy, cx, flip, size, is_mask=False)
        masks = [apply_crop_flip(m, scale, cy, cx, flip, size, is_mask=True)
                 for m in masks]
        pairs = [(m, l) for m, l in zip(masks, labels) if m.any()]
        if not pairs:
            return None
        masks = [m for m, _ in pairs]
        labels = [l for _, l in pairs]
        stacked, valid = pad_stack(masks, self.capacity, size)
        padded_labels = np.zeros((self.capacity,), np.int32)
        padded_labels[: len(labels[: self.capacity])] = labels[: self.capacity]
        return {
            "image": image.astype(np.float32),
            "masks": stacked,
            "labels": padded_labels,
            "valid": valid,
            "gt_object_class": np.int32(record.get("object_class", item.get("class_id", 0))),
            "image_id": item["image_id"],
        }


@dataclasses.dataclass
class PartDistillationSaveMapper:
    """Stage-5 save input: image + the stage-4 part masks (their union is
    the object region) + gt_object_class, resized without augmentation (the
    reference's save pass, part_distillation_model.py:290-311)."""

    image_size: int = 640
    capacity: int = 8

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        record = _stage4_record(item)
        if record is None:
            return None
        masks = _decode_rles(record.get("part_masks", []))
        if not masks:
            return None
        labels = list(record.get("part_labels", [0] * len(masks)))
        size = (self.image_size, self.image_size)
        image = resize_image(image, size)
        masks = [resize_mask(m, size) for m in masks]
        object_mask = np.zeros(size, bool)
        for m in masks:
            object_mask |= m
        if not object_mask.any():
            return None
        stacked, valid = pad_stack(masks, self.capacity, self.image_size)
        padded = np.zeros((self.capacity,), np.int32)
        padded[: len(labels[: self.capacity])] = labels[: self.capacity]
        return {
            "image": image.astype(np.float32),
            "object_mask": object_mask,
            "part_masks": stacked,
            "part_labels": padded,
            "part_valid": valid,
            "gt_object_class": np.int32(record.get("object_class", item.get("class_id", 0))),
            "image_id": item["image_id"],
        }


@dataclasses.dataclass
class PartEvalMapper:
    """PartImageNet items: {image, object_mask, gt_part_masks (T,S,S),
    gt_part_labels, gt_valid, object_class}. ``merge_parts_by_class`` merges
    all instances of one part class into a single GT mask."""

    image_size: int = 640
    capacity: int = 16
    merge_parts_by_class: bool = True

    def __call__(self, item: dict) -> Optional[dict]:
        image = load_image(item["file_name"])
        if image is None:
            return None
        size = (self.image_size, self.image_size)
        image = resize_image(image, size)

        parts: List[np.ndarray] = []
        labels: List[int] = []
        object_mask = np.zeros(size, bool)

        if "annotations" in item:  # PartImageNet COCO anns
            from .datasets.part_imagenet import ann_to_mask

            h, w = item.get("height"), item.get("width")
            by_class: Dict[int, np.ndarray] = {}
            for ann in item["annotations"]:
                m = resize_mask(ann_to_mask(ann, h, w), size)
                cid = int(ann["category_id"])
                if self.merge_parts_by_class:
                    by_class[cid] = by_class.get(cid, np.zeros(size, bool)) | m
                else:
                    parts.append(m)
                    labels.append(cid)
            for cid, m in sorted(by_class.items()):
                parts.append(m)
                labels.append(cid)
        elif "objects" in item or "part_png" in item:
            raise NotImplementedError(
                "PartEvalMapper: Pascal-Parts and Cityscapes items are not ported yet "
                "(ROADMAP: the remaining eval datasets)")
        else:
            return None

        for m in parts:
            object_mask |= m
        if not parts or not object_mask.any():
            return None
        stacked, valid = pad_stack(parts, self.capacity, self.image_size)
        padded = np.zeros((self.capacity,), np.int32)
        padded[: len(labels[: self.capacity])] = labels[: self.capacity]
        return {
            "image": image.astype(np.float32),
            "object_mask": object_mask,
            "gt_part_masks": stacked,
            "gt_part_labels": padded,
            "gt_valid": valid,
            "object_class": np.int32(item.get("class_id", 0)),
            "image_id": item["image_id"],
        }
