"""mIoU evaluation and majority-vote matching over per-object-class confusion
matrices, numpy only.

The port's own copy of the JAX package's ``evaluation/miou.py`` (one
process):
  * ``MIoUMatcher``: per object class, a (n+1, n+1) confusion matrix between
    predicted cluster ids and GT part labels (n = max(pred, gt) classes, the
    last row and column unlabeled pixels); the majority vote maps each
    cluster row to its GT column of most overlap;
  * ``MIoUEvaluator``: per object class a (gt+1, gt+1) confusion matrix and
    its mIoU / mACC / mIoPred; C-* is the mean over object classes, A-* the
    mean over all parts of all classes.
Masks are rasterised in slot order, later slots overwriting earlier ones.
With ``distributed`` the matrices of every rank of ``group`` (the mesh's
data group; the world by default) are gathered and summed
(``merge_confusion_dicts``) before the vote or the metrics, so each rank
evaluates its shard of the images and every rank reports the result of them
all. The metrics average the object classes in the order they were first
seen (rank by rank after a gather), as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = [
    "binary_masks_to_semseg",
    "confusion_matrix",
    "majority_vote",
    "merge_confusion_dicts",
    "miou_from_confusion",
    "MIoUMatcher",
    "MIoUEvaluator",
]


def binary_masks_to_semseg(masks: np.ndarray, classes: np.ndarray, fill: int) -> np.ndarray:
    """(K, H, W) bool/f32 + (K,) labels -> (H, W) label map; later masks
    overwrite. f32 mask stacks are thresholded at 0.5."""
    semseg = np.full(masks.shape[1:], fill, np.int64)
    for i in range(len(masks)):
        semseg[np.asarray(masks[i]) > 0.5] = classes[i]
    return semseg


def confusion_matrix(pd: np.ndarray, gt: np.ndarray, n: int) -> np.ndarray:
    """(H, W) pred / gt label maps with labels in [0, n] -> (n+1, n+1)
    counts, rows = pred, columns = gt."""
    return np.bincount(
        (n + 1) * pd.reshape(-1) + gt.reshape(-1), minlength=(n + 1) ** 2
    ).reshape(n + 1, n + 1).astype(np.float64)


def majority_vote(conf: np.ndarray, pred_classes: int, gt_classes: int) -> np.ndarray:
    """Per predicted-cluster row, the GT class with the most overlap."""
    return conf[:pred_classes, :gt_classes].argmax(axis=1).astype(np.int32)


def miou_from_confusion(conf: np.ndarray) -> Dict[str, np.ndarray]:
    """mIoU / mACC / mIoPred (in percent) and their per-class values of one
    confusion matrix whose last row and column are unlabeled pixels."""
    num_classes = conf.shape[0] - 1
    acc = np.full(num_classes, np.nan)
    iou = np.full(num_classes, np.nan)
    iopred = np.full(num_classes, np.nan)
    tp = conf.diagonal()[:-1].astype(float)
    pos_gt = conf[:, :-1].sum(axis=0).astype(float)
    pos_pred = conf[:-1, :].sum(axis=1).astype(float)
    acc_valid = pos_gt > 0
    iou_valid = (pos_gt + pos_pred) > 0
    iopred_valid = pos_pred > 0
    union = pos_gt + pos_pred - tp
    acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
    iou[acc_valid] = tp[acc_valid] / union[acc_valid]
    iopred[iopred_valid] = tp[iopred_valid] / pos_pred[iopred_valid]
    macc = np.sum(acc[acc_valid]) / max(np.sum(acc_valid), 1)
    miou = np.sum(iou[acc_valid]) / max(np.sum(iou_valid), 1)
    miopred = np.sum(iopred[iopred_valid]) / max(np.sum(iopred_valid), 1)
    return {
        "mIoU": 100 * miou, "mACC": 100 * macc, "mIoPred": 100 * miopred,
        "per_class_iou": 100 * iou, "per_class_acc": 100 * acc,
        "per_class_iopred": 100 * iopred,
    }


def merge_confusion_dicts(dicts: List[Dict[int, np.ndarray]]) -> Dict[int, np.ndarray]:
    """Sum per-object-class confusion matrices; key sets may differ."""
    merged: Dict[int, np.ndarray] = {}
    for d in dicts:
        for k, v in d.items():
            merged[k] = merged.get(k, 0) + v
    return merged


class _ConfusionAccumulator:
    def __init__(self, n: int):
        self.n = n
        self.conf: Dict[int, np.ndarray] = {}

    def add(self, obj_class: int, pred_masks, pred_classes, gt_masks, gt_classes):
        pd = binary_masks_to_semseg(pred_masks, pred_classes, self.n)
        gt = binary_masks_to_semseg(gt_masks, gt_classes, self.n)
        c = confusion_matrix(pd, gt, self.n)
        if obj_class not in self.conf:
            self.conf[obj_class] = np.zeros_like(c)
        self.conf[obj_class] += c

    def process(self, outputs, gt_masks, gt_labels, gt_valid, object_class):
        pm = np.asarray(outputs["pred_masks"])
        pc = np.asarray(outputs["pred_labels"])
        va = np.asarray(outputs["valid"])
        gm = np.asarray(gt_masks)
        gl = np.asarray(gt_labels)
        gv = np.asarray(gt_valid)
        oc = np.asarray(object_class)
        for b in range(pm.shape[0]):
            self.add(int(oc[b]), pm[b][va[b]], pc[b][va[b]], gm[b][gv[b]], gl[b][gv[b]])

    def allreduce(self, distributed: bool, group=None) -> None:
        """Sum the matrices over the ranks of ``group`` when distributed;
        key sets may differ by rank."""
        if distributed:
            from ..engine.launch import all_gather_objects

            self.conf = merge_confusion_dicts(all_gather_objects(self.conf, group))


class MIoUMatcher:
    """The 'match' phase: cluster id x GT part confusion -> vote mapping."""

    def __init__(self, pred_classes: int = 8, gt_classes: int = 8,
                 distributed: bool = False, group=None):
        self.pred_classes = pred_classes
        self.gt_classes = gt_classes
        self.n = max(pred_classes, gt_classes)
        self.distributed = distributed
        self.group = group
        self.reset()

    def reset(self):
        self._acc = _ConfusionAccumulator(self.n)

    def process(self, outputs, gt_masks, gt_labels, gt_valid, object_class):
        self._acc.process(outputs, gt_masks, gt_labels, gt_valid, object_class)

    def evaluate(self) -> Dict[int, np.ndarray]:
        self._acc.allreduce(self.distributed, self.group)
        return {k: majority_vote(conf, self.pred_classes, self.gt_classes)
                for k, conf in self._acc.conf.items()}


class MIoUEvaluator:
    """Per-object-class mIoU / mACC / mIoPred with C- / A- aggregation."""

    def __init__(self, gt_classes: int, distributed: bool = False, group=None):
        self.gt_classes = gt_classes
        self.distributed = distributed
        self.group = group
        self.reset()

    def reset(self):
        self._acc = _ConfusionAccumulator(self.gt_classes)

    def process(self, outputs, gt_masks, gt_labels, gt_valid, object_class):
        self._acc.process(outputs, gt_masks, gt_labels, gt_valid, object_class)

    def evaluate(self) -> Dict[str, float]:
        self._acc.allreduce(self.distributed, self.group)
        agg = {"C-mIoU": [], "A-mIoU": [], "C-mACC": [], "A-mACC": [],
               "C-mIoPred": [], "A-mIoPred": []}
        for conf in self._acc.conf.values():
            r = miou_from_confusion(conf)
            agg["C-mIoU"].append(r["mIoU"])
            agg["A-mIoU"].extend([v for v in r["per_class_iou"] if not np.isnan(v)])
            agg["C-mACC"].append(r["mACC"])
            agg["A-mACC"].extend([v for v in r["per_class_acc"] if not np.isnan(v)])
            agg["C-mIoPred"].append(r["mIoPred"])
            agg["A-mIoPred"].extend([v for v in r["per_class_iopred"] if not np.isnan(v)])
        return {k: float(np.mean(v)) if len(v) else float("nan") for k, v in agg.items()}
