"""The supervised / fewshot part-segmentation ablation.

Counterpart of the JAX package's ``models/meta_arch/supervised.py``: the
Mask2Former skeleton trained on real part ground truth, with the reference's
two switches:
  * ``class_agnostic_learning``: train with all-zero labels (one class), as
    the stage-3 proposal model does;
  * ``class_agnostic_inference``: score each query by its largest class
    probability and keep its argmax, instead of the top-k over every
    (query, part class) probability.
Fewshot learning is the same model trained on a ``label_percentage`` subset
of the GT set (the CLI's data layer). Its criterion keeps the JAX package's
default ``importance_sample_ratio`` of 0.75, the reference's PointRend
importance sampling (``losses/criterion.py``'s random mode).
  * ``make_loss_fn``: the train step's loss (``ProposalLoss`` with the GT
    part labels as targets);
  * ``make_inference_fn``: mask logits upsampled to the image, the scoring
    above, object masking, unique per-pixel assignment merged into
    ``num_part_classes`` semantic channels, the conditional ratio and score
    filters; ``SupervisedMIoUEvaluator`` reads its output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ... import resolve_device
from ...losses.criterion import CriterionConfig
from ...ops.instance_post import (
    as_bool_mask,
    conditional_ratio_filter,
    conditional_score_filter,
    merge_by_class,
    stable_topk,
    unique_assignment,
)
from ..segmenter import MaskFormerSegmenter, SegmenterConfig
from .proposal import ProposalLoss, normalize_images, upsample_mask_logits

__all__ = ["SupervisedModelConfig", "SupervisedLoss", "make_loss_fn", "make_inference_fn"]


@dataclasses.dataclass(frozen=True)
class SupervisedModelConfig:
    segmenter: SegmenterConfig = SegmenterConfig()
    criterion: CriterionConfig = CriterionConfig(num_classes=1, importance_sample_ratio=0.75)
    num_part_classes: int = 40
    class_agnostic_learning: bool = False
    class_agnostic_inference: bool = False
    test_topk: int = 200
    use_unique_per_pixel_label: bool = True
    min_score: float = -1.0
    min_ratio: float = -1.0
    apply_object_masking: bool = True


class SupervisedLoss(ProposalLoss):
    """``loss_fn(batch, noise) -> (total_loss, losses)`` of the supervised
    train step. batch: image (B, H, W, 3), masks (B, T, H, W) bool, labels
    (B, T) GT part classes, valid (B, T) bool; noise as ``ProposalLoss``'s
    (``draw_noise`` fills the random mode's point pools)."""

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in ("image", "masks", "labels", "valid")}

    def targets(self, t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        valid = t["valid"].bool()
        labels = torch.zeros(valid.shape, dtype=torch.long, device=valid.device) \
            if self.cfg.class_agnostic_learning else t["labels"].long()
        return {"labels": labels, "masks": t["masks"].float(), "valid": valid}


def make_loss_fn(cfg: SupervisedModelConfig, model: MaskFormerSegmenter,
                 device: Optional[str] = None, group=None) -> SupervisedLoss:
    """The supervised train step's loss on ``device`` (``cuda`` unless told
    otherwise); ``group`` the data group of a data-parallel step."""
    return SupervisedLoss(cfg, model, device, group)


def _infer_one(cfg: SupervisedModelConfig, logits, mask_logits,
               object_mask) -> Dict[str, torch.Tensor]:
    n_cls = cfg.num_part_classes
    q = logits.shape[0]
    mask_logits = upsample_mask_logits(mask_logits, *object_mask.shape)
    probs = torch.softmax(logits, dim=-1)[:, :-1]  # (Q, C)
    if cfg.class_agnostic_inference:
        top_scores, idx = stable_topk(probs.max(dim=-1).values, min(cfg.test_topk, q))
        top_labels = probs.argmax(dim=-1).int()[idx]
        masks = mask_logits[idx]
    else:
        c = probs.shape[-1]
        top_scores, flat_idx = stable_topk(probs.reshape(-1), min(cfg.test_topk, q * c))
        top_labels = (flat_idx % c).int()
        masks = mask_logits[flat_idx // c]
    if cfg.apply_object_masking:
        masks = masks * object_mask[None].to(masks.dtype)

    valid = torch.ones(top_scores.shape, dtype=torch.bool, device=masks.device)
    if cfg.use_unique_per_pixel_label:
        seg, obj_map, valid = unique_assignment(masks, top_scores, valid)
        cmasks, cscores, cvalid = merge_by_class(seg, top_scores, top_labels, valid, n_cls)
        clabels = torch.arange(n_cls, dtype=torch.int32, device=masks.device)
    else:
        cmasks, cscores, clabels, cvalid = masks > 0.0, top_scores, top_labels, valid
        obj_map = cmasks.any(dim=0)
    cvalid = conditional_ratio_filter(cmasks, cvalid, obj_map, cfg.min_ratio)
    cvalid = conditional_score_filter(cscores, cvalid, cfg.min_score)
    return {"pred_masks": cmasks, "scores": cscores, "pred_labels": clabels, "valid": cvalid}


def make_inference_fn(cfg: SupervisedModelConfig, model: MaskFormerSegmenter, device=None):
    """Returns ``infer_fn(batch) -> dict`` of batched tensors on ``device``
    (``cuda`` unless told otherwise): pred_masks (B, L, H, W) bool, scores
    (B, L), pred_labels (B, L) int32, valid (B, L) bool, with L =
    ``num_part_classes`` (merged semantic channels) under the unique
    per-pixel assignment, else the top-k. batch (numpy arrays or tensors):
    image (B, H, W, 3), object_mask (B, H, W)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def infer_fn(batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            t = {k: torch.as_tensor(batch[k], device=dev) for k in ("image", "object_mask")}
            outputs = model(normalize_images(t["image"]))
            object_mask = as_bool_mask(t["object_mask"])
            per_image = [_infer_one(cfg, outputs["pred_logits"][i], outputs["pred_masks"][i],
                                    object_mask[i])
                         for i in range(outputs["pred_logits"].shape[0])]
            return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}

    return infer_fn
