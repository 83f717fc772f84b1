"""Stage-4 cross-image feature clustering: the per-object-class centroid bank.

Counterpart of the JAX package's ``evaluation/clustering.py``
(``ClusteringModule``): the decoder features of each object class's
proposals accumulate on the host into a reservoir of ``capacity_per_class``
rows (algorithm R, a uniform sample of the whole stream, drawn from
``RandomState(SEED + 12345)``: the same buffers as the JAX package's for the
same stream); ``evaluate()`` then runs the masked k-means of every class
with more than k features on the device, 64 classes a chunk, and gives the
classes with at most k features ``RandomState(SEED).randn`` centroids, as
the reference does (clustering_module.py:63-64).

Each class is seeded by k-means++ from uniforms keyed by its own id
(``ops.kmeans.seed_uniforms``), so the bank does not depend on the chunk
size. The JAX package's keys cannot be reproduced here: its bank and this
one agree given the same seeding (``_seed`` is the one place it is drawn).
Multi-process runs (the JAX package's ``distributed``, ``merge_reservoirs``
and all-gather) wait for multi-GPU support (ROADMAP §1 item 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from ..ops.kmeans import kmeans_pp_init, lloyd, seed_uniforms

__all__ = ["ClusteringModule"]

# The JAX package's default seed, which its CLI never changes.
SEED = 0


class ClusteringModule:
    def __init__(self, num_object_classes: int, feat_dim: int, num_clusters: int = 8,
                 capacity_per_class: int = 4096, kmeans_chunk: int = 64,
                 device=None):
        self.num_object_classes = num_object_classes
        self.feat_dim = feat_dim
        self.k = num_clusters
        self.cap = capacity_per_class
        self.kmeans_chunk = kmeans_chunk
        self.device = resolve_device(device)
        self.reset()

    def reset(self):
        self._feats: Dict[int, np.ndarray] = {}
        self._seen: Dict[int, int] = {}
        self._rng = np.random.RandomState(SEED + 12345)

    def process(self, outputs: Dict, object_class):
        """outputs: {feats (B, K, D), valid (B, K)} (numpy); object_class (B,)."""
        feats = np.asarray(outputs["feats"], np.float32)
        valid = np.asarray(outputs["valid"])
        oc = np.asarray(object_class)
        for b in range(feats.shape[0]):
            c = int(oc[b])
            f = feats[b][valid[b]]
            if len(f) == 0:
                continue
            buf = self._feats.get(c)
            if buf is None:
                buf = self._feats[c] = np.zeros((self.cap, self.feat_dim), np.float32)
            seen = self._seen.get(c, 0)
            for row in f:  # reservoir sampling (algorithm R)
                if seen < self.cap:
                    buf[seen] = row
                else:
                    j = self._rng.randint(seen + 1)
                    if j < self.cap:
                        buf[j] = row
                seen += 1
            self._seen[c] = seen

    def counts(self) -> np.ndarray:
        """(num_object_classes,) rows held per class."""
        counts = np.zeros((self.num_object_classes,), np.int64)
        for c, s in self._seen.items():
            if 0 <= c < self.num_object_classes:
                counts[c] = min(s, self.cap)
        return counts

    def _seed(self, x: torch.Tensor, mask: torch.Tensor, classes: np.ndarray) -> torch.Tensor:
        """k-means++ centroids (C, k, D) of one chunk of classes."""
        u = torch.as_tensor(seed_uniforms(SEED, classes, self.k), device=x.device)
        return kmeans_pp_init(x, mask, u)

    def evaluate(self) -> np.ndarray:
        """Returns the classifier bank: (num_object_classes, k, D) f32 centroids."""
        counts = self.counts()
        cents = np.zeros((self.num_object_classes, self.k, self.feat_dim), np.float32)
        todo = np.nonzero(counts > self.k)[0]
        chunk = max(self.kmeans_chunk, 1)
        rows = torch.arange(self.cap, device=self.device)
        for start in range(0, len(todo), chunk):
            idx = todo[start:start + chunk]
            x = torch.as_tensor(np.stack([self._feats[c] for c in idx]), device=self.device)
            m = rows[None, :] < torch.as_tensor(counts[idx], device=self.device)[:, None]
            out, _ = lloyd(x, m, self._seed(x, m, idx))
            cents[idx] = out.cpu().numpy()

        # classes with too few samples: random centroids (reference behaviour)
        rng = np.random.RandomState(SEED)
        few = counts <= self.k
        if few.any():
            cents[few] = rng.randn(int(few.sum()), self.k, self.feat_dim).astype(np.float32)
        return cents
