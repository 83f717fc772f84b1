"""Instance post-processing on fixed-capacity candidate sets (one image).

Counterpart of the JAX package's ``ops/instance_post.py``: unique per-pixel
assignment, the reference's conditional filters (applied only if at least one
candidate survives), merging by class label, and top-1 IoU GT matching.
"""

from __future__ import annotations

import torch

__all__ = ["as_bool_mask", "unique_assignment", "conditional_ratio_filter",
           "conditional_score_filter", "merge_by_class", "mask_iou_matrix", "match_gt_top1"]


def as_bool_mask(m: torch.Tensor) -> torch.Tensor:
    """bool passes through; float mask stacks are thresholded at 0.5."""
    return m if m.dtype == torch.bool else m > 0.5


def unique_assignment(mask_logits, scores, valid):
    """mask_logits (K, H, W), scores (K,), valid (K,) bool ->
    (seg (K, H, W) bool, obj_map (H, W) bool, valid (K,) bool). Each pixel goes
    to the valid candidate with the largest score * sigmoid(logit), within the
    object map (any valid logit > 0); slots owning no pixel become invalid."""
    k = mask_logits.shape[0]
    vmask = valid[:, None, None]
    obj_map = ((mask_logits > 0.0) & vmask).any(dim=0)
    scored = scores[:, None, None] * torch.sigmoid(mask_logits)
    scored = torch.where(vmask, scored, torch.tensor(-float("inf"), dtype=scored.dtype,
                                                     device=scored.device))
    winner = scored.argmax(dim=0)
    seg = (winner[None] == torch.arange(k, device=winner.device)[:, None, None]) & obj_map[None]
    return seg, obj_map, valid & seg.any(dim=(1, 2))


def conditional_ratio_filter(masks, valid, obj_map, min_ratio: float):
    """valid &= area(mask) / area(obj_map) > min_ratio, if any candidate passes."""
    area = masks.sum(dim=(1, 2)).float()
    obj_area = obj_map.sum().float().clamp(min=1.0)
    keep = (area / obj_area) > min_ratio
    return torch.where((keep & valid).any(), valid & keep, valid)


def conditional_score_filter(scores, valid, min_score: float):
    keep = scores > min_score
    return torch.where((keep & valid).any(), valid & keep, valid)


def merge_by_class(masks, scores, labels, valid, num_classes: int):
    """Union of the valid slots of each class label in [0, num_classes);
    a class's score is its slots' largest. Labels outside the range are
    dropped. Returns (class_masks (C, H, W) bool, class_scores (C,),
    class_valid (C,))."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels[:, None] == classes[None]) & valid[:, None]  # (K, C)
    k, h, w = masks.shape
    class_masks = (onehot.t().float() @ masks.reshape(k, h * w).float()).reshape(-1, h, w) > 0.0
    class_scores = torch.where(onehot.t(), scores[None, :],
                               torch.full_like(scores, -float("inf"))[None, :]).amax(dim=1)
    class_valid = onehot.any(dim=0)
    return class_masks, torch.where(class_valid, class_scores, torch.zeros_like(class_scores)), \
        class_valid


def mask_iou_matrix(a, b):
    """(K, H, W) x (T, H, W) boolean masks -> (K, T) IoU."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    inter = af @ bf.t()
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1.0), torch.zeros_like(inter))


def match_gt_top1(masks, valid, gt_masks, gt_labels, gt_valid,
                  iou_threshold: float = 0.001):
    """Top-1 IoU match of each candidate to GT; candidates below the threshold
    become invalid. Returns (matched_labels (K,), matched_idx (K,) int32,
    valid (K,))."""
    iou = mask_iou_matrix(masks, gt_masks)
    iou = torch.where(gt_valid[None, :], iou, torch.full_like(iou, -1.0))
    top1_idx = iou.argmax(dim=1)
    top1_iou = iou.gather(1, top1_idx[:, None])[:, 0]
    return gt_labels[top1_idx], top1_idx.int(), valid & (top1_iou > iou_threshold)
