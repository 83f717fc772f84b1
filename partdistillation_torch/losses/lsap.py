"""Exact linear-sum assignment on the host, in numpy.

Counterpart of the JAX package's ``losses/lsap.py``: the same
shortest-augmenting-path algorithm (Dijkstra over reduced costs with dual
potentials, the one scipy implements), step for step and in float32, so ties
break as they do there (first index of the minimum). The JAX package runs it
on the device inside its compiled step; here the matcher copies every cost
matrix of a train step to the host in one transfer, solves them all, and
copies the assignments back in one transfer (``losses/matcher.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["solve_lsap", "solve_lsap_batch"]

_INF = np.float32(1e18)


def solve_lsap(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of R rows to C columns, R <= C: (R, C) cost ->
    (R,) int64 column of each row."""
    cost = np.asarray(cost, np.float32)
    r, c = cost.shape
    if r > c:
        raise ValueError(f"solve_lsap requires rows <= cols, got {cost.shape}")
    u, v = np.zeros(r, np.float32), np.zeros(c, np.float32)
    row4col, col4row = np.full(c, -1, np.int64), np.full(r, -1, np.int64)
    rows = np.arange(r)
    for cur_row in range(r):
        # Dijkstra from cur_row until a free column is reached
        scanned_r, scanned_c = np.zeros(r, bool), np.zeros(c, bool)
        shortest = np.full(c, _INF, np.float32)
        pred = np.full(c, -1, np.int64)
        i, min_val, sink = cur_row, np.float32(0.0), -1
        while sink < 0:
            scanned_r[i] = True
            reduced = min_val + cost[i] - u[i] - v
            upd = ~scanned_c & (reduced < shortest)
            shortest = np.where(upd, reduced, shortest)
            pred = np.where(upd, i, pred)
            masked = np.where(scanned_c, _INF, shortest)
            j = int(np.argmin(masked))
            min_val = masked[j]
            scanned_c[j] = True
            if row4col[j] < 0:
                sink = j
            else:
                i = int(row4col[j])
        # dual updates
        u[cur_row] += min_val
        others = scanned_r & (rows != cur_row)
        sp_at_col = np.where(col4row >= 0, shortest[np.clip(col4row, 0, None)],
                             np.float32(0.0))
        u = np.where(others, u + (min_val - sp_at_col), u)
        v = np.where(scanned_c, v + (shortest - min_val), v)
        # augment along the alternating path back from the sink
        j = sink
        while True:
            i = int(pred[j])
            row4col[j] = i
            j, col4row[i] = int(col4row[i]), j
            if i == cur_row:
                break
    return col4row


def solve_lsap_batch(costs: np.ndarray) -> np.ndarray:
    """(..., R, C) costs -> (..., R) assignments."""
    costs = np.asarray(costs, np.float32)
    flat = costs.reshape((-1,) + costs.shape[-2:])
    return np.stack([solve_lsap(c) for c in flat]).reshape(costs.shape[:-1])
