"""Stage-3 ProposalModel: class-agnostic part proposals.

Counterpart of the JAX package's ``models/meta_arch/proposal.py``:
  * ``make_loss_fn``: the train step's loss, the segmenter in training mode
    (DropPath active) against the pseudo part masks with all-zero labels,
    through the set criterion with deep supervision. Its randomness (DropPath
    keep decisions, matcher and point-grid jitter) is an explicit ``noise``
    input that ``draw_noise`` fills from a ``torch.Generator``;
  * ``make_inference_fn``: upsample the mask logits to image resolution,
    score = class-0 softmax probability, top-k, object-mask gating, optional
    unique per-pixel assignment, conditional area-ratio / score filters,
    top-1 IoU GT matching; fixed-capacity (K slots + validity) tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...losses.criterion import CriterionConfig, set_criterion, supervised_layers
from ...losses.matcher import hungarian_match, match_noise
from ...ops.instance_post import (
    as_bool_mask,
    conditional_ratio_filter,
    conditional_score_filter,
    match_gt_top1,
    stable_topk,
    unique_assignment,
)
from ..segmenter import PIXEL_MEAN, PIXEL_STD, MaskFormerSegmenter, SegmenterConfig

__all__ = ["ProposalModelConfig", "normalize_images", "make_loss_fn", "ProposalLoss",
           "make_inference_fn", "upsample_mask_logits", "stable_topk", "object_gate"]


@dataclasses.dataclass(frozen=True)
class ProposalModelConfig:
    segmenter: SegmenterConfig = SegmenterConfig()
    criterion: CriterionConfig = CriterionConfig(num_classes=1)
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


class ProposalLoss:
    """``loss_fn(batch, noise) -> (total_loss, losses)`` of the stage-3 train
    step. batch (numpy arrays or tensors): image (B, H, W, 3), masks
    (B, T, H, W) bool, valid (B, T) bool. noise: ``drop_keep`` (blocks, 2, B)
    bool, the matcher's and the criterion's points as their point modes take
    them (``losses/criterion.py``; in grid mode ``match_jitter`` (L, B, 2) and
    ``point_jitter`` (L, B, T, 2)) with L the supervised layers (final
    first), and optionally ``indices`` (L, B, T), matched queries that
    replace the matcher's. ``group``: the data group of
    a data-parallel step, whose normalisers the criterion takes (``local``
    names those left per rank: a planted fault for the checks)."""

    def __init__(self, cfg: ProposalModelConfig, model: MaskFormerSegmenter, device=None,
                 group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.group = group
        self.local: tuple = ()

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in ("image", "masks", "valid")}

    def targets(self, t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        valid = t["valid"].bool()
        return {"labels": torch.zeros(valid.shape, dtype=torch.long, device=valid.device),
                "masks": t["masks"].float(), "valid": valid}

    def forward(self, t: Dict[str, torch.Tensor], noise) -> Dict:
        return self.model(normalize_images(t["image"]), drop_keep=noise["drop_keep"])

    def match(self, outputs: Dict, t: Dict[str, torch.Tensor], noise) -> torch.Tensor:
        """(L, B, T) matched queries (one host round trip)."""
        matcher = self.cfg.criterion.matcher
        return hungarian_match(supervised_layers(outputs), self.targets(t),
                               match_noise(noise, matcher), matcher)

    def criterion(self, outputs: Dict, t: Dict[str, torch.Tensor], noise):
        return set_criterion(outputs, self.targets(t), noise, self.cfg.criterion,
                             noise.get("indices"), self.group, self.local)

    def __call__(self, batch, noise):
        t = self.device_batch(batch)
        return self.criterion(self.forward(t, noise), t, noise)

    def draw_noise(self, batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh noise for ``batch`` from ``generator`` (on the loss's device)."""
        b, t = tuple(batch["masks"].shape[:2])
        seg, crit = self.cfg.segmenter, self.cfg.criterion
        layers = seg.supervised_layers
        dev = self.device

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        backbone = seg.backbone_config
        keep_prob = torch.as_tensor(1.0 - backbone.drop_path_rates(), dtype=torch.float32,
                                    device=dev)
        noise = {"drop_keep": uniform(backbone.num_blocks, 2, b) < keep_prob[:, None, None]}
        if crit.matcher.point_mode == "random":
            noise["match_points"] = uniform(layers, b, crit.matcher.num_points, 2)
        else:
            noise["match_jitter"] = uniform(layers, b, 2)
        n_imp = crit.n_importance
        if crit.resolved_point_mode() == "random":
            if n_imp:
                noise["point_pool"] = uniform(layers, b, t, crit.n_pool, 2)
            noise["point_fresh"] = uniform(layers, b, t, crit.num_points - n_imp, 2)
        elif n_imp == 0:
            noise["point_jitter"] = uniform(layers, b, t, 2)
        return noise


def make_loss_fn(cfg: ProposalModelConfig, model: MaskFormerSegmenter,
                 device: Optional[str] = None, group=None) -> ProposalLoss:
    """The stage-3 train step's loss on ``device`` (``cuda`` unless told
    otherwise): ``loss_fn(batch, noise) -> (total_loss, losses)``; ``group``
    the data group of a data-parallel step."""
    return ProposalLoss(cfg, model, device, group)


def upsample_mask_logits(mask_logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(K, h', w') -> (K, h, w), bilinear at half-pixel centres."""
    return F.interpolate(mask_logits[None], size=(h, w), mode="bilinear",
                         align_corners=False)[0]


def object_gate(mask_logits, object_masks, object_valid):
    """Zero the mask logits outside the union of the valid object masks."""
    obj = (object_masks & object_valid[:, None, None]).any(dim=0)
    return mask_logits * obj[None].to(mask_logits.dtype)


def _infer_one(cfg: ProposalModelConfig, logits, mask_logits, part_masks, part_labels,
               part_valid, object_masks, object_valid) -> Dict[str, torch.Tensor]:
    topk = cfg.test_topk
    mask_logits = upsample_mask_logits(mask_logits, *part_masks.shape[-2:])
    # softmax over classes incl. no-object, drop no-object, top-1 class
    probs = torch.softmax(logits, dim=-1)[:, :-1]
    scores, idx = stable_topk(probs.max(dim=-1).values, topk)
    mask_logits = mask_logits[idx]

    if cfg.apply_object_masking:
        mask_logits = object_gate(mask_logits, object_masks, object_valid)

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
