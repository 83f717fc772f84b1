"""Stage-5 PartDistillationModel: self-training of the per-object-class part
classifier.

Counterpart of the JAX package's ``models/meta_arch/part_distillation.py``:
  * ``make_loss_fn``: the stage-3 train step's loss (``ProposalLoss``) with
    the stage-4 part masks' cluster labels in [0, num_parts) as targets and
    each image's ``gt_object_class`` selecting its P + 1 live columns of the
    part head; the criterion runs in that (P + 1)-way space
    (``criterion.num_classes = num_parts``);
  * ``make_inference_fn(mode=...)``: scores = the softmax over the P + 1
    live logits without no-object, flattened over (query, part) and the
    top-k kept; in ``eval`` mode each kept label goes through the
    majority-vote mapping (cluster id -> GT part id) of the image's object
    class; object-mask gating, unique per-pixel assignment and merging by
    label, the conditional filters, top-1 IoU GT matching, the oracle
    classifier option. ``save`` mode gives the cluster labels that the
    predictions store keeps.

One difference from the JAX package, a repair: in ``eval`` mode the JAX
package merges the mapped labels, which lie in the GT label space, over
[0, num_parts) and so drops every mapped label >= num_parts; here they are
merged over the mapped label space (``num_label_space``, the GT part count),
as the JAX package's stage-4 ranking model does.
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
    match_gt_top1,
    merge_by_class,
    unique_assignment,
)
from ..segmenter import MaskFormerSegmenter, SegmenterConfig
from .proposal import (
    ProposalLoss,
    normalize_images,
    object_gate,
    stable_topk,
    upsample_mask_logits,
)

__all__ = ["PartDistillationConfig", "PartDistillationLoss", "make_loss_fn",
           "make_inference_fn", "shard_part_head", "PART_HEAD_WEIGHT"]

MODES = ("save", "eval")
PART_HEAD_WEIGHT = "sem_seg_head.predictor.part_class_embed.weight"


@dataclasses.dataclass(frozen=True)
class PartDistillationConfig:
    segmenter: SegmenterConfig = SegmenterConfig()
    criterion: CriterionConfig = CriterionConfig(num_classes=8)
    num_parts: int = 8
    test_topk: int = 200
    use_unique_per_pixel_label: bool = True
    min_score: float = -1.0
    min_ratio: float = -1.0
    apply_object_masking: bool = True
    match_iou_threshold: float = 0.001
    use_oracle_classifier: bool = False


class PartDistillationLoss(ProposalLoss):
    """``loss_fn(batch, noise) -> (total_loss, losses)`` of the stage-5 train
    step. batch: image (B, H, W, 3), masks (B, T, H, W) bool, labels (B, T)
    int in [0, num_parts), valid (B, T) bool, gt_object_class (B,) int;
    noise as ``ProposalLoss``'s."""

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in ("image", "masks", "labels", "valid", "gt_object_class")}

    def targets(self, t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"labels": t["labels"].long(), "masks": t["masks"].float(),
                "valid": t["valid"].bool()}

    def forward(self, t: Dict[str, torch.Tensor], noise) -> Dict:
        return self.model(normalize_images(t["image"]), drop_keep=noise["drop_keep"],
                          gt_object_class=t["gt_object_class"])


def make_loss_fn(cfg: PartDistillationConfig, model: MaskFormerSegmenter,
                 device: Optional[str] = None, group=None) -> PartDistillationLoss:
    """The stage-5 train step's loss on ``device`` (``cuda`` unless told
    otherwise): ``loss_fn(batch, noise) -> (total_loss, losses)``; ``group``
    the data group of a data-parallel step."""
    return PartDistillationLoss(cfg, model, device, group)


def shard_part_head(model: MaskFormerSegmenter, mesh) -> Dict[str, int]:
    """Split the part head's weight along its hidden dimension over the
    mesh's model group (nothing on a mesh of one model rank). Returns the
    Trainer's ``sharded`` map: {parameter name: the dimension split}."""
    if mesh.n_model == 1:
        return {}
    model.sem_seg_head.predictor.part_class_embed.shard(mesh.model_group, mesh.model_index,
                                                        mesh.n_model)
    return {PART_HEAD_WEIGHT: 1}


def _infer_one(cfg: PartDistillationConfig, mode: str, label_space: int, logits, mask_logits,
               obj_class, mapping, part_masks, part_labels, part_valid, object_masks,
               object_valid) -> Dict[str, torch.Tensor]:
    p, topk = cfg.num_parts, cfg.test_topk
    mask_logits = upsample_mask_logits(mask_logits, *part_masks.shape[-2:])
    scores = torch.softmax(logits, dim=-1)[:, :-1]  # (Q, P)
    top_scores, top_idx = stable_topk(scores.reshape(-1), topk)
    top_labels = (top_idx % p).int()
    if mode == "eval":
        top_labels = mapping[obj_class][top_labels.long()].int()
    masks = mask_logits[top_idx // p]

    if cfg.apply_object_masking:
        masks = object_gate(masks, object_masks, object_valid)

    valid = torch.ones((topk,), dtype=torch.bool, device=masks.device)
    if cfg.use_unique_per_pixel_label:
        seg, obj_map, valid = unique_assignment(masks, top_scores, valid)
        cmasks, cscores, cvalid = merge_by_class(seg, top_scores, top_labels, valid,
                                                 label_space)
        clabels = torch.arange(label_space, dtype=torch.int32, device=masks.device)
    else:
        cmasks = masks > 0.0
        cscores, clabels, cvalid = top_scores, top_labels, valid
        obj_map = cmasks.any(dim=0)
    cvalid = conditional_ratio_filter(cmasks, cvalid, obj_map, cfg.min_ratio)
    cvalid = conditional_score_filter(cscores, cvalid, cfg.min_score)

    gt_labels, _, matched_valid = match_gt_top1(cmasks, cvalid, part_masks, part_labels,
                                                part_valid, cfg.match_iou_threshold)
    return {"pred_masks": cmasks, "scores": cscores,
            "pred_labels": gt_labels if cfg.use_oracle_classifier else clabels,
            "gt_matched_labels": gt_labels,
            "valid": matched_valid if mode == "eval" else cvalid}


def make_inference_fn(cfg: PartDistillationConfig, model: MaskFormerSegmenter,
                      mode: str = "save", num_label_space: Optional[int] = None, device=None):
    """Returns ``infer_fn(batch, majority_vote_mapping=None) -> dict`` of
    batched tensors on ``device`` (``cuda`` unless told otherwise):
    pred_masks (B, L, H, W) bool, scores (B, L), pred_labels (B, L),
    gt_matched_labels (B, L), valid (B, L) bool, with L = ``num_label_space``
    when the unique per-pixel assignment merges by label, else ``test_topk``.

    mode: "save" (cluster labels, merged over [0, num_parts)) or "eval" (each
    label mapped through ``majority_vote_mapping`` (num_object_classes,
    num_parts) of the image's object class, then merged over
    [0, num_label_space), which ``eval`` requires: the GT part count).
    batch (numpy arrays or tensors): image (B, H, W, 3); gt_object_class
    (B,); part_masks (B, T, H, W) + part_labels (B, T) + part_valid (B, T)
    (GT parts, for matching); object_masks (B, O, H, W) + object_valid (B, O).
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}: one of {MODES}")
    if mode == "eval" and num_label_space is None:
        raise ValueError("eval mode merges mapped labels: give num_label_space "
                         "(the GT part count)")
    label_space = cfg.num_parts if mode == "save" else num_label_space
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def infer_fn(batch, majority_vote_mapping=None) -> Dict[str, torch.Tensor]:
        if mode == "eval" and majority_vote_mapping is None:
            raise ValueError("eval mode needs the majority-vote mapping")
        with torch.inference_mode():
            t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            mapping = None if majority_vote_mapping is None else \
                torch.as_tensor(majority_vote_mapping, device=dev).long()
            obj = t["gt_object_class"].long()
            outputs = model(normalize_images(t["image"]), gt_object_class=obj)
            part_masks = as_bool_mask(t["part_masks"])
            object_masks = as_bool_mask(t["object_masks"])
            per_image = [
                _infer_one(cfg, mode, label_space, outputs["pred_logits"][i],
                           outputs["pred_masks"][i], obj[i], mapping, part_masks[i],
                           t["part_labels"][i], t["part_valid"][i].bool(), object_masks[i],
                           t["object_valid"][i].bool())
                for i in range(outputs["pred_logits"].shape[0])]
            return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}

    return infer_fn
