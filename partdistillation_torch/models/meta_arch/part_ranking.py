"""Stage-4 PartRankingModel: cluster -> classify -> label -> majority vote.

Counterpart of the JAX package's ``models/meta_arch/part_ranking.py``
(the reference's PartRankingModel, part_ranking_model.py:28-566, and its
modal evaluation):

  * ``make_cluster_fn``: per image, the top-k proposals by class-0 score,
    unique per-pixel assignment and the conditional filters (min_*_1), the
    object-mask gate, the top-1 IoU match to the image's stage-2/3 masks
    (fg threshold 0.001); each surviving proposal's l2-normalised decoder
    feature goes to the per-class k-means (``evaluation.clustering``);
  * ``classifier_scores``: 'dot' or the reference's negative l2 distance,
    2ab - a^2 - b^2;
  * ``make_label_fn``: score(q, c) = class-0 probability x softmax over the
    object class's centroid scores, the flattened top-k over (Q x k),
    the vote mapping in EVAL mode, unique assignment, merging by label over
    ``num_label_space``, the conditional filters (min_*_2) and the top-1 IoU
    match (MATCH and EVAL keep only matched slots).

The model runs batched under ``torch.inference_mode``; the post-processing
runs per image, as stage 5's ``make_inference_fn``. Products of the decoder's
features with the f32 centroid bank are f32 (JAX promotes bf16 x f32 to
f32); the features are normalised in the decoder's dtype, as JAX does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

import torch

from ... import resolve_device
from ...ops.instance_post import (
    as_bool_mask,
    conditional_ratio_filter,
    conditional_score_filter,
    match_gt_top1,
    merge_by_class,
    unique_assignment,
)
from ...utils.precision import full_f32
from ..segmenter import MaskFormerSegmenter, SegmenterConfig
from .proposal import normalize_images, stable_topk, upsample_mask_logits

__all__ = ["PartRankingConfig", "RankingMode", "make_cluster_fn", "make_label_fn",
           "classifier_scores"]


class RankingMode(str, enum.Enum):
    CLUSTER = "cluster"
    SAVE = "save"
    MATCH = "match"
    EVAL = "eval"


@dataclasses.dataclass(frozen=True)
class PartRankingConfig:
    segmenter: SegmenterConfig = SegmenterConfig()
    num_clusters: int = 8
    classifier_metric: str = "l2"  # l2 | dot
    test_topk: int = 200
    use_unique_clustering: bool = True
    use_unique_labeling: bool = True
    apply_object_masking: bool = True


# The JAX package's defaults, which its CLI never changes: the conditional
# filters before clustering (min_*_1) and after labeling (min_*_2) keep
# every proposal, and a proposal matches a target above IoU 0.001.
MIN_RATIO = 0.0
MIN_SCORE = 0.0
FG_IOU_THRESHOLD = 0.001


def _normed(feats: torch.Tensor) -> torch.Tensor:
    return feats / (torch.linalg.vector_norm(feats, dim=-1, keepdim=True) + 1e-12)


def _forward(model: MaskFormerSegmenter, dev, batch):
    """The segmenter over the batch's images, and the batch on ``dev``."""
    t = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    outputs = model(normalize_images(t["image"]))
    return outputs, _normed(outputs["decoder_output"]), t


def _cluster_one(cfg: PartRankingConfig, logits, mask_logits, feats, tgt_masks, tgt_valid,
                 obj_mask):
    topk = cfg.test_topk
    mask_logits = upsample_mask_logits(mask_logits, *tgt_masks.shape[-2:])
    scores, idx = stable_topk(torch.softmax(logits, dim=-1)[:, :-1].amax(-1), topk)
    mask_logits = mask_logits[idx]
    feats = feats[idx]

    valid = torch.ones((topk,), dtype=torch.bool, device=scores.device)
    if cfg.use_unique_clustering:
        masks_bool, obj_map, valid = unique_assignment(mask_logits, scores, valid)
    else:
        masks_bool = mask_logits > 0.0
        obj_map = masks_bool.any(dim=0)
    valid = conditional_ratio_filter(masks_bool, valid, obj_map, MIN_RATIO)
    valid = conditional_score_filter(scores, valid, MIN_SCORE)

    if cfg.apply_object_masking:
        masks_bool = masks_bool & obj_mask[None]

    tgt_labels = torch.zeros(tgt_masks.shape[:1], dtype=torch.int32, device=tgt_masks.device)
    _, _, valid = match_gt_top1(masks_bool, valid, tgt_masks, tgt_labels, tgt_valid,
                                FG_IOU_THRESHOLD)
    return {"pred_masks": masks_bool, "scores": scores, "feats": feats, "valid": valid}


def make_cluster_fn(cfg: PartRankingConfig, model: MaskFormerSegmenter, device=None):
    """Returns ``cluster_fn(batch) -> dict`` of batched tensors on ``device``
    (``cuda`` unless told otherwise): pred_masks (B, K, H, W) bool, scores
    (B, K), feats (B, K, D) in the decoder's dtype, valid (B, K) bool, with
    K = ``test_topk``.

    batch (numpy arrays or tensors): image (B, H, W, 3); masks (B, T, H, W)
    (the image's stage-2/3 proposals, the targets of the match); mask_valid
    (B, T); object_mask (B, H, W).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def cluster_fn(batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            outputs, feats, t = _forward(model, dev, batch)
            masks, obj = as_bool_mask(t["masks"]), as_bool_mask(t["object_mask"])
            per_image = [
                _cluster_one(cfg, outputs["pred_logits"][i], outputs["pred_masks"][i], feats[i],
                             masks[i], t["mask_valid"][i].bool(), obj[i])
                for i in range(feats.shape[0])]
            return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}

    return cluster_fn


def classifier_scores(feats: torch.Tensor, centroids: torch.Tensor, metric: str) -> torch.Tensor:
    """(Q, D) x (k, D) -> (Q, k) f32: 'dot', or the reference's negative l2
    distance 2ab - a^2 - b^2 (part_ranking_model.py:448-463), a^2 in the
    features' dtype."""
    with full_f32(feats.device):
        ab = feats.float() @ centroids.float().t()
    if metric == "dot":
        return ab
    aa = (feats * feats).sum(-1, keepdim=True)
    bb = (centroids * centroids).sum(-1)
    return 2.0 * ab - aa - bb[None, :]


def _label_one(cfg: PartRankingConfig, mode: RankingMode, label_space: int, logits,
               mask_logits, feats, obj_label, centroids, mapping, tgt_masks, tgt_labels,
               tgt_valid, obj_mask):
    k, topk = cfg.num_clusters, cfg.test_topk
    mask_logits = upsample_mask_logits(mask_logits, *tgt_masks.shape[-2:])
    object_scores = torch.softmax(logits, dim=-1)[:, :1]  # (Q, 1) class 0
    cls_scores = torch.softmax(
        classifier_scores(feats, centroids[obj_label], cfg.classifier_metric), dim=-1)
    top_scores, top_idx = stable_topk((object_scores * cls_scores).reshape(-1), topk)
    top_labels = (top_idx % k).int()
    if mode == RankingMode.EVAL:
        top_labels = mapping[obj_label][top_labels.long()].int()
    masks = mask_logits[top_idx // k]

    if cfg.apply_object_masking:
        masks = masks * obj_mask[None].to(masks.dtype)

    valid = torch.ones((topk,), dtype=torch.bool, device=masks.device)
    if cfg.use_unique_labeling:
        seg, obj_map, valid = unique_assignment(masks, top_scores, valid)
        cmasks, cscores, cvalid = merge_by_class(seg, top_scores, top_labels, valid, label_space)
        clabels = torch.arange(label_space, dtype=torch.int32, device=masks.device)
    else:
        cmasks = masks > 0.0
        cscores, clabels, cvalid = top_scores, top_labels, valid
        obj_map = cmasks.any(dim=0)
    cvalid = conditional_ratio_filter(cmasks, cvalid, obj_map, MIN_RATIO)
    cvalid = conditional_score_filter(cscores, cvalid, MIN_SCORE)

    matched_labels, _, matched_valid = match_gt_top1(cmasks, cvalid, tgt_masks, tgt_labels,
                                                     tgt_valid, FG_IOU_THRESHOLD)
    use_match = mode in (RankingMode.MATCH, RankingMode.EVAL)
    return {"pred_masks": cmasks, "scores": cscores, "pred_labels": clabels,
            "gt_matched_labels": matched_labels,
            "valid": matched_valid if use_match else cvalid}


def make_label_fn(cfg: PartRankingConfig, model: MaskFormerSegmenter,
                  mode: RankingMode = RankingMode.SAVE, num_label_space: Optional[int] = None,
                  device=None):
    """Returns ``label_fn(batch, centroids, mapping=None) -> dict`` of
    batched tensors on ``device`` (``cuda`` unless told otherwise):
    pred_masks (B, L, H, W) bool, scores / pred_labels / gt_matched_labels /
    valid (B, L), with L = ``num_label_space`` (default k) under unique
    labeling, else ``test_topk``.

    centroids: (num_object_classes, k, D) the per-class classifier bank
    (upload it once: a device tensor is used as it is); mapping:
    (num_object_classes, k) the majority-vote mapping (EVAL mode; zeros when
    not given). batch: image (B, H, W, 3); object_label (B,); masks
    (B, T, H, W) + mask_labels (B, T) + mask_valid (B, T) (labeling targets
    or GT parts); object_mask (B, H, W).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    mode = RankingMode(mode)
    label_space = num_label_space or cfg.num_clusters

    def label_fn(batch, centroids, mapping=None) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            outputs, feats, t = _forward(model, dev, batch)
            cents = torch.as_tensor(centroids, device=dev)
            mapping = (torch.zeros((cents.shape[0], cfg.num_clusters), dtype=torch.long,
                                   device=dev) if mapping is None
                       else torch.as_tensor(mapping, device=dev).long())
            obj_label = t["object_label"].long()
            masks, obj = as_bool_mask(t["masks"]), as_bool_mask(t["object_mask"])
            per_image = [
                _label_one(cfg, mode, label_space, outputs["pred_logits"][i],
                           outputs["pred_masks"][i], feats[i], obj_label[i], cents, mapping,
                           masks[i], t["mask_labels"][i], t["mask_valid"][i].bool(), obj[i])
                for i in range(feats.shape[0])]
            return {k: torch.stack([r[k] for r in per_image]) for k in per_image[0]}

    return label_fn
