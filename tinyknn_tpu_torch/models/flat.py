"""Flat: exact brute-force index (counterpart of tinyknn_tpu/models/flat.py).

Exact search with the IVF calling convention, on ``knn_brute``: the
ground-truth generator of the benchmarks and a usable index at small
scale. State lives on the device given at construction, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from ..utils.bruteforce import knn_brute, l2_normalize
from .fast_pq import as_f32


class Flat:
    """Exact nearest-neighbour index with the IVF calling convention."""

    def __init__(self, metric="euclidean", device="cuda"):
        if metric not in ("euclidean", "angular"):
            raise ValueError(f"metric must be euclidean or angular, not "
                             f"{metric!r}")
        self.metric = metric
        self.device = torch.device(device)
        self.data = None

    def fit(self, X, verbose=False):
        return self

    def build(self, X, n_probes=None, verbose=False):
        X = as_f32(X, self.device)
        if self.metric == "angular":
            X = l2_normalize(X)
        self.data = X
        return self

    def query(self, q, k, n_probes=None, pass_1=None):
        """Exact top-k row indices, int64 (k,) for one query (d,) or
        (Q, k) for a batch, nearest first; k is capped at the corpus
        size. ``n_probes`` and ``pass_1`` are accepted and ignored."""
        if self.data is None:
            raise RuntimeError("Flat index is empty: call build(X) first")
        q = as_f32(q, self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        k = min(k, int(self.data.shape[0]))
        idx = knn_brute(q, self.data, k, metric=self.metric)
        return idx[0] if single else idx
