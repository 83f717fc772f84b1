"""Class-agnostic Average-Recall evaluator (AR@{1,10,50,100,200}), numpy only.

The port's own copy of the JAX package's ``evaluation/proposal_evaluator.py``:
per image, proposals sorted by score, truncated to the k budget, greedy
best-IoU matching against GT masks, recall averaged over IoU thresholds
0.5:0.05:0.95. With ``distributed`` the records of every rank of ``group``
(the mesh's data group; the world by default) are gathered before the
evaluation, so each rank evaluates its shard of the images and every rank
reports the metrics of them all.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["greedy_gt_overlaps", "ProposalEvaluator"]


def _pairwise_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    p = pred.reshape(len(pred), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = p @ g.T
    union = p.sum(-1)[:, None] + g.sum(-1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)


def greedy_gt_overlaps(proposals: np.ndarray, scores: np.ndarray, gts: np.ndarray,
                       limit: Optional[int] = None) -> np.ndarray:
    """Per-GT matched IoU after greedy best-first assignment (one image)."""
    order = np.argsort(-scores, kind="stable")
    proposals = proposals[order]
    if limit is not None and len(proposals) > limit:
        proposals = proposals[:limit]
    if len(proposals) == 0 or len(gts) == 0:
        return np.zeros((len(gts),), np.float64)
    overlaps = _pairwise_iou(proposals, gts)
    out = np.zeros(len(gts))
    for j in range(min(len(proposals), len(gts))):
        max_over = overlaps.max(axis=0)
        gt_ind = int(np.argmax(max_over))
        box_ind = int(np.argmax(overlaps[:, gt_ind]))
        out[j] = overlaps[box_ind, gt_ind]
        overlaps[box_ind, :] = -1
        overlaps[:, gt_ind] = -1
    return out


class ProposalEvaluator:
    """reset/process/evaluate protocol over fixed-capacity model outputs."""

    def __init__(self, limits: Tuple[int, ...] = (1, 10, 50, 100, 200),
                 distributed: bool = False, group=None):
        self.limits = limits
        self.distributed = distributed
        self.group = group
        self.reset()

    def reset(self):
        self._records: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def process(self, outputs: Dict[str, np.ndarray], gt_masks: np.ndarray,
                gt_valid: np.ndarray):
        """outputs: batched {pred_masks (B,K,H,W), scores (B,K), valid (B,K)};
        gt_masks (B,T,H,W) bool; gt_valid (B,T)."""
        pm = np.asarray(outputs["pred_masks"])
        sc = np.asarray(outputs["scores"])
        va = np.asarray(outputs["valid"])
        gm = np.asarray(gt_masks)
        gv = np.asarray(gt_valid)
        for b in range(pm.shape[0]):
            self._records.append((pm[b][va[b]], sc[b][va[b]], gm[b][gv[b]]))

    def evaluate(self) -> Dict[str, float]:
        records = self._records
        if self.distributed:
            from ..engine.launch import all_gather_objects

            records = [r for rank in all_gather_objects(records, self.group) for r in rank]
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        res: Dict[str, float] = {}
        for limit in self.limits:
            all_overlaps = []
            num_pos = 0
            for pred, score, gt in records:
                if len(pred) == 0 or len(gt) == 0:
                    continue
                num_pos += len(gt)
                all_overlaps.append(greedy_gt_overlaps(pred, score, gt, limit))
            ov = np.concatenate(all_overlaps) if all_overlaps else np.zeros(0)
            recalls = np.array([(ov >= t).sum() / max(num_pos, 1) for t in thresholds])
            res[f"AR@{limit}"] = float(recalls.mean() * 100)
        res["# instances"] = float(len(records))
        return res
