"""Set criterion: Hungarian-matched classification + point-sampled mask losses.

Counterpart of the JAX package's ``losses/criterion.py``:
  * CE over all queries, unmatched queries get the no-object class weighted
    0.1, normalised by the sum of the per-query weights;
  * per matched pair, sigmoid CE (mean over points) and dice (+1/+1) on
    ``num_points`` points per target, summed over valid targets and divided
    by max(valid count, 1). The points, by ``resolved_point_mode()``:
    "grid" without importance sampling, one jittered regular grid; "random",
    the reference's PointRend sampling: of an iid pool of
    int(P * oversample_ratio) points the int(ratio * P) most uncertain
    (-|logit| as ``point_sample`` reads it, ties to the lower index as
    ``lax.top_k`` breaks them), then P - n_imp fresh iid points; "grid" with
    a ratio > 0, every pixel of the prediction's own grid weighted: 1 for the
    ~ratio * P most uncertain (a 12-step threshold bisection in f32) plus the
    fresh points' expected weight for all;
  * deep supervision: the same losses for the final and every auxiliary
    layer, total = sum of class / mask / dice weighted losses.
The points' randomness is an input (``noise``), layer 0 being the final
output: the matcher's (``matcher.match_noise``) and, in grid mode, the
per-target jitter ``point_jitter`` (L, B, T, 2), in random mode the pool
``point_pool`` (L, B, T, int(P * oversample_ratio), 2) and the fresh points
``point_fresh`` (L, B, T, P - n_imp, 2). The loss weights are the constants
every configuration of the JAX package uses. ``importance_sample_ratio``
defaults to 0 here, the value of every CLI but the supervised ones (JAX's
default is 0.75, which the supervised CLIs keep).

In a data-parallel step (``group``, the mesh's data group) the normalisers
are the group's: the mask count is the all-reduced valid count over the
group's size, clamped at 1, as the JAX package's ``axis_name`` psum gives
it, and each layer's CE weight sum is the all-reduced sum over the group's
size. The mean of the ranks' gradients (DDP's average) is then the gradient
of the loss over the group's global batch, the JAX package's mesh step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.instance_post import stable_topk
from ..ops.sampling import grid_point_sample, point_sample
from .matcher import MatcherConfig, grid_axes, hungarian_match, match_noise

__all__ = ["CriterionConfig", "point_losses", "set_criterion", "supervised_layers",
           "uncertain_points", "importance_weights"]

CLASS_WEIGHT, MASK_WEIGHT, DICE_WEIGHT, NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    matcher: MatcherConfig = MatcherConfig()
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.0
    point_mode: str = "auto"  # "grid" | "random" | "auto"

    def resolved_point_mode(self) -> str:
        """"auto": grid without importance sampling, else random."""
        if self.point_mode != "auto":
            return self.point_mode
        return "grid" if self.importance_sample_ratio == 0 else "random"

    @property
    def n_importance(self) -> int:
        return int(self.importance_sample_ratio * self.num_points)

    @property
    def n_pool(self) -> int:
        return int(self.num_points * self.oversample_ratio)


def point_losses(logits: torch.Tensor, labels: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """Per mask, over the last axis: (sigmoid CE mean over points, dice),
    each point weighted by ``weights`` when given."""
    ce_pp = labels * F.softplus(-logits) + (1.0 - labels) * F.softplus(logits)
    probs = torch.sigmoid(logits)
    if weights is None:
        ce = ce_pp.mean(-1)
        inter, psum, tsum = (probs * labels).sum(-1), probs.sum(-1), labels.sum(-1)
    else:
        ce = (weights * ce_pp).sum(-1) / weights.sum(-1).clamp(min=1e-6)
        inter = (weights * probs * labels).sum(-1)
        psum, tsum = (weights * probs).sum(-1), (weights * labels).sum(-1)
    dice = 1.0 - (2.0 * inter + 1.0) / (psum + tsum + 1.0)
    return ce, dice


def uncertain_points(pred_m: torch.Tensor, pool: Optional[torch.Tensor], fresh: torch.Tensor,
                     n_imp: int) -> torch.Tensor:
    """The random mode's points: pred_m (..., h, w) logits, pool (..., S, 2)
    and fresh (..., F, 2) iid points as (x, y) in [0, 1] -> (..., n_imp + F,
    2): the pool's n_imp most uncertain points, then the fresh ones."""
    if n_imp == 0:
        return fresh
    with torch.no_grad():
        vals = point_sample(pred_m[..., None], pool)[..., 0]
        _, idx = stable_topk(-vals.abs(), n_imp)
        imp = torch.gather(pool, -2, idx[..., None].expand(*idx.shape, 2))
    return torch.cat([imp, fresh], dim=-2)


def importance_weights(uncertainty: torch.Tensor, k: int, uniform_w: float,
                       iters: int = 12) -> torch.Tensor:
    """The dense mode's weights over the last axis: bisect a threshold t so
    that ~k entries have uncertainty >= t; those weigh 1 + uniform_w, the
    rest uniform_w. f32, as the JAX package computes it."""
    lo = uncertainty.amin(-1)
    hi = uncertainty.amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        count = (uncertainty >= mid[..., None]).sum(-1)
        too_many = count > k  # raise the threshold
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    sel = (uncertainty >= (0.5 * (lo + hi))[..., None]).float()
    return sel + uniform_w


def supervised_layers(outputs: Dict):
    """The final output, then the auxiliary layers' outputs in order."""
    return [outputs] + list(outputs.get("aux_outputs", []))


def _class_weights(out, targets, matched, cfg: CriterionConfig):
    """(target classes (B, Q), their CE weights (B, Q)) of one layer:
    matched queries take their target's label, the rest the no-object class
    at weight NO_OBJECT_WEIGHT."""
    b, q, _ = out["pred_logits"].shape
    no_object = cfg.num_classes
    vals = torch.where(targets["valid"], targets["labels"].long(),
                       torch.full_like(matched, no_object))
    target_classes = torch.full((b, q), no_object, dtype=torch.long, device=matched.device)
    target_classes = target_classes.scatter(1, matched, vals)
    return target_classes, torch.where(target_classes == no_object, NO_OBJECT_WEIGHT, 1.0)


def _mask_point_losses(pred_m, tgt_masks, noise: Dict[str, torch.Tensor],
                       cfg: CriterionConfig):
    """Per matched pair (B, T): the point losses of pred_m (B, T, h, w)
    against tgt_masks (B, T, H, W) f32, given one layer's noise."""
    n_imp = cfg.n_importance
    if cfg.resolved_point_mode() == "random":
        coords = uncertain_points(pred_m, noise.get("point_pool"), noise["point_fresh"], n_imp)
        logits = point_sample(pred_m[..., None], coords)[..., 0]
        with torch.no_grad():
            labels = point_sample(tgt_masks[..., None], coords)[..., 0]
        return point_losses(logits, labels)
    if n_imp == 0:  # one jittered regular grid a target
        ys, xs = grid_axes(noise["point_jitter"], cfg.num_points)  # (B, T, gy), (B, T, gx)
        logits = grid_point_sample(pred_m[..., None], ys, xs).flatten(2)
        with torch.no_grad():
            labels = grid_point_sample(tgt_masks[..., None], ys, xs).flatten(2)
        return point_losses(logits, labels)
    # dense importance weighting on the prediction's own pixel grid; the
    # target is brought onto that grid by one separable resample
    h, w = pred_m.shape[-2:]
    lead = pred_m.shape[:-2]
    dev = pred_m.device
    ys = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h).expand(*lead, h)
    xs = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w).expand(*lead, w)
    with torch.no_grad():
        labels = grid_point_sample(tgt_masks[..., None], ys, xs).flatten(-3)
    logits = pred_m.flatten(-2)
    weights = importance_weights(-logits.detach().abs(), n_imp,
                                 (cfg.num_points - n_imp) / (h * w))
    return point_losses(logits, labels, weights)


def _single_layer_losses(out, targets, matched, noise, cfg: CriterionConfig,
                         num_masks, target_classes, class_w,
                         class_w_sum) -> Dict[str, torch.Tensor]:
    pred_logits = out["pred_logits"].float()
    pred_masks = out["pred_masks"].float()
    valid = targets["valid"]

    nll = -torch.gather(F.log_softmax(pred_logits, dim=-1), 2, target_classes[..., None])[..., 0]
    loss_ce = (class_w * nll).sum() / class_w_sum

    pred_m = torch.gather(pred_masks, 1, matched[:, :, None, None].expand(
        -1, -1, *pred_masks.shape[-2:]))  # (B, T, h, w)
    ce, dice = _mask_point_losses(pred_m, targets["masks"], noise, cfg)
    vmask = valid.float()
    return {"loss_ce": loss_ce, "loss_mask": (ce * vmask).sum() / num_masks,
            "loss_dice": (dice * vmask).sum() / num_masks}


def _normalisers(valid, class_ws, group, local: Tuple[str, ...]):
    """(num_masks, [each layer's CE denominator]) of this rank's losses."""
    sums = torch.stack([valid.float().sum(), *[w.sum() for w in class_ws]])
    if group is None:
        return torch.clamp(sums[0], min=1.0), [torch.clamp(s, min=1e-6) for s in sums[1:]]
    size = dist.get_world_size(group)
    total = sums.detach().clone()
    dist.all_reduce(total, group=group)
    num_masks = torch.clamp(sums[0] if "num_masks" in local else total[0] / size, min=1.0)
    ce = sums[1:] if "class_weight" in local else total[1:]
    return num_masks, [torch.clamp(s, min=1e-6) / (1 if "class_weight" in local else size)
                       for s in ce]


def set_criterion(outputs: Dict, targets: Dict[str, torch.Tensor],
                  noise: Dict[str, torch.Tensor], cfg: CriterionConfig,
                  indices: Optional[torch.Tensor] = None, group=None,
                  local: Tuple[str, ...] = (),
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full criterion with deep supervision.

    targets: labels (B, T) int, masks (B, T, H, W) f32, valid (B, T) bool.
    noise: the matcher's (``match_noise``) and the point mode's (module
    docstring), each with the L supervised layers first.
    indices: (L, B, T) matched queries, or None to run the matcher (one host
    round trip for all layers). Returns (total_loss, losses); the final
    layer's losses are ``loss_ce`` / ``loss_mask`` / ``loss_dice``, layer i's
    auxiliary losses carry the suffix ``_{i}``. group: the data group of a
    data-parallel step (None: this batch is the whole batch); its
    normalisers take one all-reduce, which carries no gradient. local:
    normalisers ("num_masks", "class_weight") left to this rank's batch, a
    planted fault for the multi-GPU checks.
    """
    layers = supervised_layers(outputs)
    if indices is None:
        indices = hungarian_match(layers, targets, match_noise(noise, cfg.matcher), cfg.matcher)
    weights = [_class_weights(out, targets, indices[i], cfg) for i, out in enumerate(layers)]
    num_masks, ce_sums = _normalisers(targets["valid"], [w for _, w in weights], group, local)
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=num_masks.device)
    point_keys = [k for k in ("point_jitter", "point_pool", "point_fresh") if k in noise]
    for i, out in enumerate(layers):
        ld = _single_layer_losses(out, targets, indices[i], {k: noise[k][i] for k in point_keys},
                                  cfg, num_masks, *weights[i], ce_sums[i])
        suffix = "" if i == 0 else f"_{i - 1}"
        for name, val in ld.items():
            losses[name + suffix] = val
        total = total + (CLASS_WEIGHT * ld["loss_ce"] + MASK_WEIGHT * ld["loss_mask"]
                         + DICE_WEIGHT * ld["loss_dice"])
    return total, losses
