"""Stage-3 ProposalModel inference: class-agnostic part proposals.

Counterpart of the JAX package's ``models/meta_arch/proposal.py``'s
``make_inference_fn``: upsample the mask logits to image resolution, score =
class-0 softmax probability, top-k, object-mask gating, optional unique
per-pixel assignment, conditional area-ratio / score filters, top-1 IoU GT
matching. Returns fixed-capacity (K slots + validity) tensors. Training (the
loss, matcher and criterion) belongs to the next slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops.instance_post import (
    as_bool_mask,
    conditional_ratio_filter,
    conditional_score_filter,
    match_gt_top1,
    unique_assignment,
)
from ..segmenter import PIXEL_MEAN, PIXEL_STD, MaskFormerSegmenter, SegmenterConfig

__all__ = ["ProposalModelConfig", "normalize_images", "make_inference_fn"]


@dataclasses.dataclass(frozen=True)
class ProposalModelConfig:
    segmenter: SegmenterConfig = SegmenterConfig()
    test_topk: int = 200
    use_unique_per_pixel_label: bool = True
    min_score: float = -1.0
    min_ratio: float = 0.0
    apply_object_masking: bool = True
    match_iou_threshold: float = 0.001


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8/float (B, H, W, 3) RGB -> ImageNet-normalised f32."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images.device)
    return (images.float() - mean) / std


def _infer_one(cfg: ProposalModelConfig, logits, mask_logits, part_masks, part_labels,
               part_valid, object_masks, object_valid) -> Dict[str, torch.Tensor]:
    topk = cfg.test_topk
    h, w = part_masks.shape[-2:]
    mask_logits = F.interpolate(mask_logits[None], size=(h, w), mode="bilinear",
                                align_corners=False)[0]
    # softmax over classes incl. no-object, drop no-object, top-1 class
    probs = torch.softmax(logits, dim=-1)[:, :-1]
    scores = probs.max(dim=-1).values
    # stable descending sort: ties keep the lower index first (lax.top_k)
    scores, idx = torch.sort(scores, descending=True, stable=True)
    scores, idx = scores[:topk], idx[:topk]
    mask_logits = mask_logits[idx]

    if cfg.apply_object_masking:
        obj = (object_masks & object_valid[:, None, None]).any(dim=0)
        mask_logits = mask_logits * obj[None].to(mask_logits.dtype)

    valid = torch.ones((topk,), dtype=torch.bool, device=scores.device)
    if cfg.use_unique_per_pixel_label:
        seg, obj_map, valid = unique_assignment(mask_logits, scores, valid)
        valid = conditional_ratio_filter(seg, valid, obj_map, cfg.min_ratio)
        valid = conditional_score_filter(scores, valid, cfg.min_score)
        masks_bool = seg
    else:
        masks_bool = mask_logits > 0.0
        obj_map = masks_bool.any(dim=0)
        valid = conditional_ratio_filter(masks_bool, valid, obj_map, cfg.min_ratio)
        valid = conditional_score_filter(scores, valid, cfg.min_score)

    gt_labels, gt_idx, valid = match_gt_top1(masks_bool, valid, part_masks, part_labels,
                                             part_valid, cfg.match_iou_threshold)
    return {"pred_masks": masks_bool, "scores": scores, "pred_labels": gt_labels,
            "matched_gt": gt_idx, "valid": valid}


def make_inference_fn(cfg: ProposalModelConfig, model: MaskFormerSegmenter, device=None):
    """Returns ``infer_fn(batch) -> dict`` of batched tensors on ``device``
    (``cuda`` unless told otherwise): pred_masks (B, K, H, W) bool, scores
    (B, K), pred_labels (B, K), matched_gt (B, K) int32, valid (B, K) bool.

    batch (numpy arrays or tensors): image (B, H, W, 3); part_masks (B, T, H, W)
    + part_labels (B, T) + part_valid (B, T) (GT parts, for matching);
    object_masks (B, O, H, W) + object_valid (B, O).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def infer_fn(batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            outputs = model(normalize_images(t["image"]))
            part_masks = as_bool_mask(t["part_masks"])
            object_masks = as_bool_mask(t["object_masks"])
            per_image = [
                _infer_one(cfg, outputs["pred_logits"][i], outputs["pred_masks"][i],
                           part_masks[i], t["part_labels"][i], t["part_valid"][i].bool(),
                           object_masks[i], t["object_valid"][i].bool())
                for i in range(outputs["pred_logits"].shape[0])]
            return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}

    return infer_fn
