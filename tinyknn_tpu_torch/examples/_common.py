"""Helpers shared by the examples: bench's stream of stacked batches, the
stream's marginal batch time, and recall."""

from __future__ import annotations

import time

import numpy as np


def stacked(queries, R: int):
    """The queries stacked R times, batch r offset by r * 1e-6 (batch 0
    is the queries themselves): bench.py's stream."""
    return queries[None] + (np.arange(R, dtype=np.float32)
                            [:, None, None] * 1e-6)


def marginal_s(run, qb1, qb2) -> float:
    """Seconds per batch at the margin between two stream lengths: one
    warm call of each, then the best of 3 in turns. ``run(qb)`` must
    return the ids (the host clock stops after they are on the host)."""
    def once(qb):
        t0 = time.time()
        run(qb).cpu()
        return time.time() - t0

    once(qb1), once(qb2)
    t1 = t2 = float("inf")
    for _ in range(3):
        t1 = min(t1, once(qb1))
        t2 = min(t2, once(qb2))
    return (t2 - t1) / (qb2.shape[0] - qb1.shape[0])


def recall(truth, ids, k: int) -> float:
    """Mean share of each query's true k neighbours among its ids."""
    return float(np.mean([len(set(t.tolist()) & set(g.tolist())) / k
                          for t, g in zip(truth, ids)]))
