"""Plain float32 set criterion, Hungarian matcher and AdamW of Mask2Former's
training step, from the published description.

Matcher: cost = 5 mean sigmoid CE + 2 (-softmax prob of the label) + 5 dice
over one set of points per image, padded targets cost 1e4, solved exactly by
``scipy.optimize.linear_sum_assignment``. Criterion: class CE over all queries
with the no-object class weighted 0.1, sigmoid CE and dice (+1/+1) on the
matched pairs' points, normalised by the number of masks; deep supervision
over the final and every auxiliary layer; total = 2 CE + 5 mask + 5 dice.
Points: a jittered regular grid (``grid``), or PointRend's importance
sampling (``random``): of an iid pool the most uncertain ``ratio`` share of
the points, then fresh iid points. The points' randomness comes in as
``noise`` arrays, the same that the program is handed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLASS_W, MASK_W, DICE_W, NO_OBJECT_W = 2.0, 5.0, 5.0, 0.1


def grid_axes(jitter: torch.Tensor, num_points: int):
    gy = math.isqrt(num_points)
    if gy * gy < num_points:
        gy += 1
    gx = -(-num_points // gy)
    ys = (torch.arange(gy, dtype=torch.float32, device=jitter.device) + jitter[..., :1]) / gy
    xs = (torch.arange(gx, dtype=torch.float32, device=jitter.device) + jitter[..., 1:]) / gx
    return ys, xs


def sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples (``grid_sample``, half-pixel centres, zeros outside):
    img (N, C, H, W), coords (N, P, 2) as (x, y) in [0, 1] -> (N, C, P)."""
    g = 2.0 * coords[:, :, None, :] - 1.0
    return F.grid_sample(img, g, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[..., 0]


def grid_coords(jitter: torch.Tensor, num_points: int) -> torch.Tensor:
    """(N, 2) jitter -> (N, gy * gx, 2) grid points as (x, y), rows first."""
    ys, xs = grid_axes(jitter, num_points)
    yy = ys[:, :, None].expand(-1, -1, xs.shape[1])
    xx = xs[:, None, :].expand(-1, ys.shape[1], -1)
    return torch.stack([xx, yy], -1).reshape(jitter.shape[0], -1, 2)


def point_losses(logits, labels):
    ce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").mean(-1)
    p = logits.sigmoid()
    dice = 1.0 - (2.0 * (p * labels).sum(-1) + 1.0) / (p.sum(-1) + labels.sum(-1) + 1.0)
    return ce, dice


@torch.no_grad()
def match(layers: List[dict], tgt: dict, noise: dict, cfg: dict) -> np.ndarray:
    """(L, B, T) matched query of every target slot for every layer."""
    masks, valid, labels = tgt["masks"], tgt["valid"], tgt["labels"]
    b, t = valid.shape
    out = np.zeros((len(layers), b, t), np.int64)
    for i, layer in enumerate(layers):
        logits, pm = layer["pred_logits"].float(), layer["pred_masks"].float()
        q, k = logits.shape[1], logits.shape[2]
        if cfg["match_point_mode"] == "random":
            coords = noise["match_points"][i]
        else:
            coords = grid_coords(noise["match_jitter"][i], cfg["num_points"])
        pred = sample(pm, coords)  # (B, Q, P)
        tp = sample(masks, coords)  # (B, T, P)
        n = pred.shape[-1]
        ce = (F.softplus(-pred) @ tp.transpose(1, 2)
              + F.softplus(pred) @ (1.0 - tp).transpose(1, 2)) / n
        prob = pred.sigmoid()
        dice = 1.0 - (2.0 * prob @ tp.transpose(1, 2) + 1.0) / (
            prob.sum(-1)[:, :, None] + tp.sum(-1)[:, None, :] + 1.0)
        cls = -torch.gather(logits.softmax(-1), 2,
                            labels.long().clamp(0, k - 1)[:, None, :].expand(b, q, t))
        cost = MASK_W * ce + CLASS_W * cls + DICE_W * dice
        cost = torch.where(valid[:, None, :], cost, torch.full_like(cost, 1e4))
        cost = cost.transpose(1, 2).cpu().numpy()
        for j in range(b):
            from scipy.optimize import linear_sum_assignment

            rows, cols = linear_sum_assignment(cost[j])
            out[i, j, rows] = cols
    return out


def mask_points(pred_m, tgt_m, noise_i: Dict[str, torch.Tensor], cfg: dict):
    """Point logits and labels (B T, P) of the matched pairs of one layer."""
    bt = pred_m.shape[0]
    if cfg["point_mode"] == "grid":
        coords = grid_coords(noise_i["point_jitter"].reshape(bt, 2), cfg["num_points"])
    else:
        n_imp = int(cfg["importance_sample_ratio"] * cfg["num_points"])
        fresh = noise_i["point_fresh"].reshape(bt, -1, 2)
        coords = fresh
        if n_imp:
            pool = noise_i["point_pool"].reshape(bt, -1, 2)
            with torch.no_grad():
                unc = -sample(pred_m[:, None], pool)[:, 0].abs()
                idx = torch.topk(unc, n_imp, dim=-1, sorted=True).indices
                imp = torch.gather(pool, 1, idx[..., None].expand(-1, -1, 2))
            coords = torch.cat([imp, fresh], 1)
    logits = sample(pred_m[:, None], coords)[:, 0]
    with torch.no_grad():
        labels = sample(tgt_m[:, None], coords)[:, 0]
    return logits, labels


def criterion(out: dict, tgt: dict, noise: dict, cfg: dict, indices: np.ndarray,
              per_image: bool = False):
    """(total, per-layer [ce, mask, dice]) of the set criterion; with
    ``per_image``, also each image's share of the total (the same
    normalisers, so the shares sum to the total)."""
    layers = [out] + list(out["aux_outputs"])
    valid = tgt["valid"]
    b, t = valid.shape
    vm = valid.float()
    num_masks = vm.sum().clamp(min=1.0)
    nc = cfg["num_classes"]
    total = torch.zeros((), device=valid.device)
    shares = torch.zeros(b, device=valid.device)
    parts = []
    for i, layer in enumerate(layers):
        logits, pm = layer["pred_logits"].float(), layer["pred_masks"].float()
        idx = torch.as_tensor(indices[i], device=valid.device)
        q = logits.shape[1]
        vals = torch.where(valid, tgt["labels"].long(), torch.full_like(idx, nc))
        tc = torch.full((b, q), nc, dtype=torch.long, device=valid.device).scatter(1, idx, vals)
        w = torch.where(tc == nc, NO_OBJECT_W, 1.0)
        nll = F.cross_entropy(logits.transpose(1, 2), tc, reduction="none")
        w_sum = w.sum().clamp(min=1e-6)
        loss_ce = (w * nll).sum() / w_sum
        pred_m = torch.gather(pm, 1, idx[:, :, None, None].expand(-1, -1, *pm.shape[-2:]))
        noise_i = {k: noise[k][i] for k in ("point_jitter", "point_pool", "point_fresh")
                   if k in noise}
        lg, lb = mask_points(pred_m.reshape(b * t, *pm.shape[-2:]),
                             tgt["masks"].reshape(b * t, *tgt["masks"].shape[-2:]), noise_i, cfg)
        ce, dice = point_losses(lg, lb)
        ce, dice = ce.reshape(b, t) * vm, dice.reshape(b, t) * vm
        loss_mask = ce.sum() / num_masks
        loss_dice = dice.sum() / num_masks
        parts.append([loss_ce, loss_mask, loss_dice])
        total = total + CLASS_W * loss_ce + MASK_W * loss_mask + DICE_W * loss_dice
        if per_image:
            shares = shares + (CLASS_W * (w * nll).sum(1) / w_sum
                               + (MASK_W * ce.sum(1) + DICE_W * dice.sum(1)) / num_masks)
    if per_image:
        return total, parts, shares
    return total, parts


def set_loss(out: dict, tgt: dict, noise: dict, cfg: dict, indices: np.ndarray = None,
             per_image: bool = False):
    """One step's set loss: the matching of every layer (unless ``indices``
    fixes it), then ``criterion``."""
    if indices is None:
        indices = match([out] + list(out["aux_outputs"]), tgt, noise, cfg)
    return criterion(out, tgt, noise, cfg, indices, per_image=per_image)


NO_DECAY = ("query_feat", "query_embed", "level_embed")


class AdamW:
    """AdamW (0.9, 0.999, 1e-8, decoupled decay) after clipping the global
    gradient norm, with frozen parameters, a backbone rate multiplier and no
    decay for vectors and embeddings (the decoder's ``NO_DECAY`` and the
    backbone's ``no_decay``), as the configuration's ``optimizer`` group
    states."""

    def __init__(self, named: Sequence, cfg: dict, no_decay: Sequence[str] = ()):
        self.cfg = cfg
        self.no_decay = NO_DECAY + tuple(no_decay)
        self.named = [(n, p) for n, p in named]
        self.frozen = tuple(cfg["freeze_keys"])
        self.m = {n: torch.zeros_like(p) for n, p in self.named}
        self.v = {n: torch.zeros_like(p) for n, p in self.named}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns the clipped gradient of every trainable leaf
        (the clipping's factor stays as ``scale``)."""
        cfg = self.cfg
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.named}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = cfg["clip_norm"] / torch.clamp(norm, min=cfg["clip_norm"])
        self.scale = float(scale)
        self.count += 1
        c = self.count
        b1, b2, eps = 0.9, 0.999, 1e-8
        out = {}
        for n, p in self.named:
            if any(k in n.lower() for k in self.frozen):
                continue
            g = grads[n] * scale
            out[n] = g
            lr = cfg["base_lr"] * (cfg["backbone_multiplier"] if "backbone" in n else 1.0)
            no_decay = p.dim() <= 1 or any(k in n for k in self.no_decay)
            decay = 0.0 if no_decay else cfg["weight_decay"]
            p.mul_(1.0 - lr * decay)
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[n] / (1 - b1 ** c)
            vhat = self.v[n] / (1 - b2 ** c)
            p.add_(-lr * mhat / (vhat.sqrt() + eps))
        return out
