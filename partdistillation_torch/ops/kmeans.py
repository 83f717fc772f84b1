"""Masked k-means, batched over a leading axis.

Counterpart of the JAX package's ``ops/kmeans.py``: k-means++ seeding over
the valid rows of a fixed-capacity point set, then Lloyd iterations in f32
whose distances and centroid sums are (N, D) x (D, k) products. Invalid rows
never contribute to an assignment or an update; empty clusters keep their
centroid; the final labels are defined for every row. The JAX package vmaps
one point set; here every function takes a batch (B, N, D).

The seeding and the Lloyd loop are two functions: ``masked_kmeans`` composes
them, and a caller (or a test) may seed by other means and call ``lloyd``.
The seeding's randomness is explicit: ``u`` holds one uniform in [0, 1) per
centroid, each drawn by inverse CDF over the k-means++ weights, so the same
uniforms give the same centroids on any device. ``seed_uniforms`` draws them
on the host from one seed per point set (an object class, an image). Every
f32 product runs inside ``utils.precision.full_f32``: TF32 would move the
centroids and flip labels.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Tuple

import numpy as np
import torch

from ..utils.precision import full_f32

__all__ = ["pairwise_sqdist", "seed_uniforms", "kmeans_pp_init", "lloyd", "masked_kmeans",
           "assign_labels"]


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., K, D) -> (..., N, K) squared euclidean distances."""
    xx = (x * x).sum(-1, keepdim=True)
    cc = (c * c).sum(-1)
    with full_f32(x.device):
        xc = x @ c.transpose(-1, -2)
    return xx + cc.unsqueeze(-2) - 2.0 * xc


def seed_uniforms(seed: int, ids: Iterable, k: int) -> np.ndarray:
    """(len(ids), k) f32 uniforms, each row from ``RandomState((seed, id))``;
    a string id is keyed by its crc32. A point set's centroids then depend on
    its own id only, not on the batch it was computed in."""
    rows = []
    for i in ids:
        key = zlib.crc32(i.encode()) if isinstance(i, str) else int(i)
        rows.append(np.random.RandomState((seed & 0xFFFFFFFF, key & 0xFFFFFFFF))
                    .random_sample(k))
    return np.asarray(rows, np.float32).reshape(-1, k)


def _draw(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row index by inverse CDF: (B, N) non-negative weights, (B,) uniforms
    -> (B,) the first index whose cumulative weight exceeds u * total (a
    row of weight 0 is never drawn while the total is positive)."""
    cdf = weights.cumsum(-1)
    target = (u * cdf[:, -1]).unsqueeze(-1)
    idx = torch.searchsorted(cdf, target.contiguous(), right=True)[:, 0]
    return idx.clamp(max=weights.shape[-1] - 1)


def kmeans_pp_init(x: torch.Tensor, mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding over the valid rows: x (B, N, D) f32, mask (B, N)
    bool, u (B, k) uniforms -> (B, k, D) centroids. The first centroid is
    drawn uniformly among the valid rows, each next one in proportion to the
    squared distance to the nearest chosen one (rows at distance 0, the
    chosen ones among them, are never drawn), uniformly over the valid rows
    when every distance is 0."""
    b, n, d = x.shape
    k = u.shape[1]
    valid = mask.to(x.dtype)
    rows = torch.arange(b, device=x.device)
    centroids = x.new_zeros((b, k, d))
    centroids[:, 0] = x[rows, _draw(valid, u[:, 0])]
    min_d = torch.where(mask, torch.full_like(valid, float("inf")), torch.zeros_like(valid))
    for i in range(1, k):
        min_d = torch.minimum(min_d, ((x - centroids[:, i - 1, None]) ** 2).sum(-1))
        w = torch.where(mask & (min_d > 0), min_d, torch.zeros_like(min_d))
        w = torch.where((w > 0).any(-1, keepdim=True), w, valid)
        centroids[:, i] = x[rows, _draw(w, u[:, i])]
    return centroids


def lloyd(x: torch.Tensor, mask: torch.Tensor, centroids: torch.Tensor,
          iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations in f32 from ``centroids`` (B, k, D) over
    the valid rows of x (B, N, D) -> (centroids (B, k, D) f32, labels (B, N)
    int32, the nearest centroid of every row, valid or not)."""
    x = x.float()
    centroids = centroids.float()
    k = centroids.shape[1]
    valid = mask.float().unsqueeze(-1)
    clusters = torch.arange(k, device=x.device)
    for _ in range(iters):
        labels = pairwise_sqdist(x, centroids).argmin(-1)
        onehot = (labels.unsqueeze(-1) == clusters).float() * valid  # (B, N, k)
        counts = onehot.sum(1)  # (B, k)
        with full_f32(x.device):
            sums = onehot.transpose(1, 2) @ x
        new = sums / counts.clamp(min=1.0).unsqueeze(-1)
        centroids = torch.where(counts.unsqueeze(-1) > 0, new, centroids)
    labels = pairwise_sqdist(x, centroids).argmin(-1).int()
    return centroids, labels


def masked_kmeans(x: torch.Tensor, mask: torch.Tensor, u: torch.Tensor,
                  iters: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over the valid rows of each point set, seeded by
    k-means++ from the uniforms ``u`` (B, k): x (B, N, D), mask (B, N) bool
    -> (centroids (B, k, D) f32, labels (B, N) int32)."""
    x = x.float()
    return lloyd(x, mask, kmeans_pp_init(x, mask, u.to(x.device, torch.float32)), iters)


def assign_labels(x: torch.Tensor, centroids: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Nearest-centroid labels, x (..., D), centroids (K, D) -> (...,) int32:
    'dot' the largest x . c, 'l2' the smallest distance."""
    if metric == "dot":
        with full_f32(x.device):
            return (x @ centroids.t()).argmax(-1).int()
    if metric == "l2":
        flat = x.reshape(-1, x.shape[-1])
        return pairwise_sqdist(flat, centroids).argmin(-1).reshape(x.shape[:-1]).int()
    raise ValueError(f"unknown metric {metric!r}")
