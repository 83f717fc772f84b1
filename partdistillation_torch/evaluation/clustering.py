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

With ``distributed`` every rank of ``group`` (the mesh's data group; the
world by default) sends the rows its reservoirs hold, and the reservoirs
are merged (``merge_reservoirs``, the JAX package's function) before the
fit; every rank then holds the same bank. The ranks of a stage-4 run own
disjoint classes, so each class's merged reservoir is its one rank's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.kmeans import kmeans_pp_init, lloyd, seed_uniforms

__all__ = ["ClusteringModule", "merge_reservoirs"]

# The JAX package's default seed, which its CLI never changes.
SEED = 0

ReservoirState = Tuple[Dict[int, np.ndarray], Dict[int, int]]


def merge_reservoirs(states: List[ReservoirState], cap: int,
                     seed: int = 0) -> ReservoirState:
    """Merge per-rank reservoirs into one.

    Each rank's buffer holds min(seen, cap) rows that are a uniform sample
    of that rank's stream. The merged buffer draws from each rank in
    proportion to its ``seen`` count (capped by what the rank stored), so
    the result approximates a uniform sample of the concatenated stream.
    """
    rng = np.random.RandomState(seed)
    all_classes = sorted({c for feats, _ in states for c in feats})
    out_feats: Dict[int, np.ndarray] = {}
    out_seen: Dict[int, int] = {}
    for c in all_classes:
        stored = [(f[c][: min(s[c], cap)], s[c]) for f, s in states if c in f]
        total_seen = sum(s for _, s in stored)
        total_stored = sum(len(b) for b, _ in stored)
        if total_stored <= cap:
            merged = np.concatenate([b for b, _ in stored], axis=0)
        else:
            # proportional draw per rank, remainders to the biggest streams
            quota = [min(len(b), int(cap * s / total_seen)) for b, s in stored]
            while sum(quota) < cap:
                room = [i for i, (b, _) in enumerate(stored) if quota[i] < len(b)]
                if not room:
                    break
                i = max(room, key=lambda i: stored[i][1])
                quota[i] += 1
            parts = []
            for (b, _), q in zip(stored, quota):
                idx = rng.permutation(len(b))[:q]
                parts.append(b[np.sort(idx)])
            merged = np.concatenate(parts, axis=0)[:cap]
        buf = np.zeros((cap, merged.shape[1]), np.float32)
        buf[: len(merged)] = merged
        out_feats[c] = buf
        out_seen[c] = total_seen
    return out_feats, out_seen


class ClusteringModule:
    def __init__(self, num_object_classes: int, feat_dim: int, num_clusters: int = 8,
                 capacity_per_class: int = 4096, kmeans_chunk: int = 64,
                 device=None, distributed: bool = False, group=None):
        self.num_object_classes = num_object_classes
        self.feat_dim = feat_dim
        self.k = num_clusters
        self.cap = capacity_per_class
        self.kmeans_chunk = kmeans_chunk
        self.device = resolve_device(device)
        self.distributed = distributed
        self.group = group
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
        """Returns the classifier bank: (num_object_classes, k, D) f32
        centroids. When distributed, this rank's reservoirs are first
        replaced by the merge of every rank's (each sends only the rows it
        holds), and ``counts`` then gives the merged reservoirs' rows."""
        if self.distributed:
            from ..engine.launch import all_gather_objects

            held = {c: buf[:min(self._seen[c], self.cap)] for c, buf in self._feats.items()}
            states = all_gather_objects((held, self._seen), self.group)
            self._feats, self._seen = merge_reservoirs(states, self.cap, SEED)
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
