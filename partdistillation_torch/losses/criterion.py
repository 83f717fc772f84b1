"""Set criterion: Hungarian-matched classification + point-sampled mask losses.

Counterpart of the JAX package's ``losses/criterion.py`` in the point mode
the stage-3 train step resolves to ("grid": no importance sampling):
  * CE over all queries, unmatched queries get the no-object class weighted
    0.1, normalised by the sum of the per-query weights;
  * per matched pair, sigmoid CE (mean over points) and dice (+1/+1) on one
    jittered regular grid of ``num_points`` points per target, summed over
    valid targets and divided by max(valid count, 1);
  * deep supervision: the same losses for the final and every auxiliary
    layer, total = sum of class / mask / dice weighted losses.
The per-image matcher jitter (L, B, 2) and per-target point jitter
(L, B, T, 2) are inputs (``noise``), layer 0 being the final output. The loss
weights are the constants every configuration of the JAX package uses. The
"random" and dense-importance point modes are not ported yet (ROADMAP).

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

from ..ops.sampling import grid_point_sample
from .matcher import MatcherConfig, grid_axes, hungarian_match

__all__ = ["CriterionConfig", "point_losses", "set_criterion", "supervised_layers"]

CLASS_WEIGHT, MASK_WEIGHT, DICE_WEIGHT, NO_OBJECT_WEIGHT = 2.0, 5.0, 5.0, 0.1


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 1
    matcher: MatcherConfig = MatcherConfig()
    num_points: int = 12544


def point_losses(logits: torch.Tensor, labels: torch.Tensor):
    """Per mask, over the last axis: (sigmoid CE mean over points, dice)."""
    ce = (labels * F.softplus(-logits) + (1.0 - labels) * F.softplus(logits)).mean(-1)
    probs = torch.sigmoid(logits)
    inter, psum, tsum = (probs * labels).sum(-1), probs.sum(-1), labels.sum(-1)
    dice = 1.0 - (2.0 * inter + 1.0) / (psum + tsum + 1.0)
    return ce, dice


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


def _single_layer_losses(out, targets, matched, point_jitter, cfg: CriterionConfig,
                         num_masks, target_classes, class_w,
                         class_w_sum) -> Dict[str, torch.Tensor]:
    pred_logits = out["pred_logits"].float()
    pred_masks = out["pred_masks"].float()
    valid = targets["valid"]

    nll = -torch.gather(F.log_softmax(pred_logits, dim=-1), 2, target_classes[..., None])[..., 0]
    loss_ce = (class_w * nll).sum() / class_w_sum

    pred_m = torch.gather(pred_masks, 1, matched[:, :, None, None].expand(
        -1, -1, *pred_masks.shape[-2:]))  # (B, T, h, w)
    ys, xs = grid_axes(point_jitter, cfg.num_points)  # (B, T, gy), (B, T, gx)
    logits = grid_point_sample(pred_m[..., None], ys, xs).flatten(2)
    with torch.no_grad():
        labels = grid_point_sample(targets["masks"][..., None], ys, xs).flatten(2)
    ce, dice = point_losses(logits, labels)
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
    noise: ``match_jitter`` (L, B, 2) and ``point_jitter`` (L, B, T, 2).
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
        indices = hungarian_match(layers, targets, noise["match_jitter"], cfg.matcher)
    weights = [_class_weights(out, targets, indices[i], cfg) for i, out in enumerate(layers)]
    num_masks, ce_sums = _normalisers(targets["valid"], [w for _, w in weights], group, local)
    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=num_masks.device)
    for i, out in enumerate(layers):
        ld = _single_layer_losses(out, targets, indices[i], noise["point_jitter"][i], cfg,
                                  num_masks, *weights[i], ce_sums[i])
        suffix = "" if i == 0 else f"_{i - 1}"
        for name, val in ld.items():
            losses[name + suffix] = val
        total = total + (CLASS_WEIGHT * ld["loss_ce"] + MASK_WEIGHT * ld["loss_mask"]
                         + DICE_WEIGHT * ld["loss_dice"])
    return total, losses
