"""Hungarian matcher with point-sampled mask costs.

Counterpart of the JAX package's ``losses/matcher.py``: class cost =
-softmax(logits)[label], mask cost = mean per-point sigmoid CE, dice cost
with +1/+1 smoothing, each over one set of ``num_points`` points per image:
a jittered regular grid (``point_mode="grid"``, the default) or iid uniform
points (``"random"``, the reference's own); padded targets get the constant
1e4 row; the cost weights are the constants every configuration of the JAX
package uses. The points' randomness, which the JAX package draws from a
key, is an input here: the grid's jitter, two uniforms per image, or the
points themselves.

The JAX package solves each (T x Q) assignment on the device. Here the costs
of every supervised layer and image are computed on the device, copied to the
host in one transfer, solved there (``losses/lsap.py``), and the indices come
back in one transfer: one host round trip per train step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sampling import grid_point_sample, point_sample
from .lsap import solve_lsap_batch

__all__ = ["MatcherConfig", "grid_axes", "batch_dice_cost", "batch_sigmoid_ce_cost",
           "match_costs", "hungarian_match", "match_noise"]


COST_CLASS, COST_MASK, COST_DICE = 2.0, 5.0, 5.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    num_points: int = 12544
    point_mode: str = "grid"  # "grid" | "random"


def match_noise(noise: Dict[str, torch.Tensor], cfg: MatcherConfig) -> torch.Tensor:
    """The matcher's share of a loss's noise: ``match_jitter`` (L, B, 2) in
    grid mode, ``match_points`` (L, B, P, 2) in random mode."""
    return noise["match_points" if cfg.point_mode == "random" else "match_jitter"]


def grid_axes(jitter: torch.Tensor, num_points: int):
    """The jittered regular grid covering >= num_points points: jitter
    (..., 2) uniforms in [0, 1) -> ys (..., gy), xs (..., gx) with
    gy = ceil(sqrt(P)), gx = ceil(P / gy)."""
    gy = math.isqrt(num_points)
    if gy * gy < num_points:
        gy += 1
    gx = -(-num_points // gy)
    dev = jitter.device
    ys = (torch.arange(gy, dtype=torch.float32, device=dev) + jitter[..., :1]) / gy
    xs = (torch.arange(gx, dtype=torch.float32, device=dev) + jitter[..., 1:]) / gx
    return ys, xs


def batch_dice_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., T, P) binary -> (..., Q, T) dice cost."""
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * probs @ targets.transpose(-1, -2)
    denominator = probs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def batch_sigmoid_ce_cost(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., T, P) binary -> (..., Q, T) mean BCE."""
    p = inputs.shape[-1]
    pos, neg = F.softplus(-inputs), F.softplus(inputs)
    loss = pos @ targets.transpose(-1, -2) + neg @ (1.0 - targets).transpose(-1, -2)
    return loss / p


def match_costs(pred_logits: torch.Tensor, pred_masks: torch.Tensor,
                targets: Dict[str, torch.Tensor], noise: torch.Tensor,
                cfg: MatcherConfig) -> torch.Tensor:
    """One layer's costs, targets x queries: pred_logits (B, Q, K) and
    pred_masks (B, Q, h, w) in the model's dtype; targets: labels (B, T) int,
    masks (B, T, H, W) f32, valid (B, T) bool; noise: the grid's jitter
    (B, 2), or in random mode the points (B, P, 2) as (x, y) in [0, 1]
    -> (B, T, Q) f32."""
    b, q, k = pred_logits.shape
    tgt_masks, tgt_valid = targets["masks"], targets["valid"]
    t = tgt_masks.shape[1]
    prob = torch.softmax(pred_logits, dim=-1)
    labels = targets["labels"].long().clamp(0, k - 1)[:, None, :].expand(b, q, t)
    cost_class = -torch.gather(prob, 2, labels).float()
    if cfg.point_mode == "random":
        pred_pts = point_sample(pred_masks.permute(0, 2, 3, 1), noise).transpose(1, 2).float()
        tgt_pts = point_sample(tgt_masks.permute(0, 2, 3, 1), noise).transpose(1, 2)
    else:
        ys, xs = grid_axes(noise, cfg.num_points)
        pred_pts = grid_point_sample(pred_masks.permute(0, 2, 3, 1), ys, xs)
        pred_pts = pred_pts.reshape(b, -1, q).transpose(1, 2).float()
        tgt_pts = grid_point_sample(tgt_masks.permute(0, 2, 3, 1), ys, xs)
        tgt_pts = tgt_pts.reshape(b, -1, t).transpose(1, 2)
    cost = (COST_MASK * batch_sigmoid_ce_cost(pred_pts, tgt_pts)
            + COST_CLASS * cost_class
            + COST_DICE * batch_dice_cost(pred_pts, tgt_pts))
    cost = torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, 1e4))
    return cost.transpose(1, 2)


@torch.no_grad()
def hungarian_match(layers: List[Dict[str, torch.Tensor]], targets: Dict[str, torch.Tensor],
                    noise: torch.Tensor, cfg: MatcherConfig) -> torch.Tensor:
    """Matched query of every target slot for each supervised layer:
    layers (L dicts of pred_logits / pred_masks), noise (L, B, 2) jitter or
    (L, B, P, 2) points (``match_noise``) -> (L, B, T) int64 on the targets'
    device (padded slots get a spare query; mask them with
    targets["valid"]). One device->host and one host->device copy for all
    L x B problems."""
    costs = torch.stack([match_costs(out["pred_logits"], out["pred_masks"], targets,
                                     noise[i], cfg) for i, out in enumerate(layers)])
    idx = solve_lsap_batch(costs.cpu().numpy())
    return torch.from_numpy(np.ascontiguousarray(idx)).to(targets["masks"].device)
