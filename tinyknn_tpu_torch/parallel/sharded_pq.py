"""Point-sharded FastPQ full-scan search over a device mesh (counterpart
of tinyknn_tpu/parallel/sharded_pq.py).

The FastPQ full-scan path (estimate every point, rescore the best) is
independent over points: the code matrix and the raw vectors are split
on dim 0, each shard runs the estimate (kernel K3 on the card) and its
own two-pass selection, and the per-shard (Q, k) results are gathered to
one device and merged, the same merge as the sharded IVF's. Corpus size
scales with the mesh; queries and tables are replicated (KB-scale).
"""

from __future__ import annotations

import torch

from ..models.fast_pq import (
    FastPQ,
    _build_tables,
    _resolve_method,
    as_f32,
    pass1_topk,
)
from ..ops.scan import estimate_scan
from ..ops.topk import smallest_k
from ..utils.bruteforce import fp32_matmuls
from ..utils.padding import round_up
from .mesh import make_mesh, replicate, shard_on_axis0
from .sharded_ivf import merge_shards, on_device


class ShardedFastPQ:
    """FastPQ search with codes and raw vectors sharded over the mesh.

    Usage matches ``FastPQ.search``: fit and transform run on one device
    (the quantizer's), ``build(X)`` places the shards, ``search`` runs
    every shard and merges on the mesh's first device.
    """

    def __init__(self, pq: FastPQ = None, mesh=None, axis="shards", **kw):
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self._grid = self.mesh.grid(axis)[0]
        if pq is None:
            kw.setdefault("device", self.mesh.devices[self._grid[0]])
            pq = FastPQ(**kw)
        self.pq = pq
        self.codes = None     # Placed uint8 (n_pad, B / 2), nibble-packed
        self.vectors = None   # Placed f32 (n_pad, d)
        self.true_n = 0

    def fit(self, X, verbose=False):
        self.pq.fit(X, verbose)
        return self

    def build(self, X, verbose=False):
        n_dev = self.mesh.shape[self.axis]
        X = as_f32(X, self.pq.device)
        self.true_n = int(X.shape[0])
        codes = self.pq.transform(X, verbose).packed
        # pad rows so that each shard gets an equal slice
        n_pad = round_up(codes.shape[0], n_dev * 8)
        codes = torch.nn.functional.pad(
            codes, (0, 0, 0, n_pad - codes.shape[0]))
        vecs = torch.nn.functional.pad(X, (0, 0, 0, n_pad - X.shape[0]))
        self.codes, self.vectors = shard_on_axis0(
            self.mesh, codes, vecs, axis=self.axis)
        self._pq_blocks = replicate(self.mesh, self.pq.center_blocks)
        self._pq_R = (None if self.pq.R is None
                      else replicate(self.mesh, self.pq.R))
        return self

    def search(self, q, k=1, rescore=None, method="auto"):
        """Top-k row indices for one query (d,) or a batch (Q, d): int32
        on the mesh's first device, -1 where fewer than k rows exist.
        Each shard rescores ``rescore`` of its own rows (default
        2k + 10, at most a shard's row count)."""
        if self.codes is None:
            raise RuntimeError("ShardedFastPQ is empty: call fit(X) and "
                               "build(X) before search")
        fp32_matmuls()
        method = _resolve_method(method)
        home = self.mesh.devices[self._grid[0]]
        q = as_f32(q, home)
        single = q.ndim == 1
        if single:
            q = q[None]
        k = min(k, self.true_n)
        if not rescore:
            rescore = min(2 * k + 10, self.true_n)
        local_n = self.codes.shape[0] // len(self._grid)
        rescore = min(rescore, local_n)
        k = min(k, rescore)
        q_on, ids, d2 = {}, [], []
        for me, pos in enumerate(self._grid):
            dev = self.mesh.devices[pos]
            if dev not in q_on:
                q_on[dev] = q.to(dev, non_blocking=True)
            with on_device(dev):
                ids_s, d2_s = _shard_local_search(
                    q_on[dev], self.codes[pos], self.vectors[pos],
                    self._pq_blocks[pos],
                    None if self._pq_R is None else self._pq_R[pos],
                    base=me * local_n, dpb=self.pq.dims_per_block,
                    true_n=self.true_n, k=k, rescore=rescore, method=method)
            ids.append(ids_s.to(home, non_blocking=True))
            d2.append(d2_s.to(home, non_blocking=True))
        with on_device(home):
            out = merge_shards(ids, d2, k, dedup=False)
        return out[0] if single else out


def _shard_local_search(q, codes_l, vecs_l, pq_blocks, pq_R, *, base: int,
                        dpb: int, true_n: int, k: int, rescore: int,
                        method: str):
    """One shard's two-pass search over its rows, global rows ``base``
    onwards: ``(ids int32 (Q, k) global rows, d2 f32 (Q, k))``, d2 +inf
    at the rows that pad the corpus."""
    local_n = codes_l.shape[0]
    tables = _build_tables(q, pq_blocks, pq_R, dpb, True).tables
    est = estimate_scan(codes_l, tables, packed=True)  # (Q, local_n) int32
    # mask the rows that pad the corpus (only the last shards have any)
    gids = base + torch.arange(local_n, device=q.device)
    est = est.masked_fill(gids >= true_n, torch.iinfo(torch.int32).max)
    _, cand = pass1_topk(est, rescore, method)        # (Q, rescore)
    diff = vecs_l[cand] - q[:, None, :]
    d2 = torch.einsum("qrd,qrd->qr", diff, diff)
    d2 = torch.where(base + cand < true_n, d2, float("inf"))
    d2, best = smallest_k(d2, k)
    return (base + torch.gather(cand, 1, best)).to(torch.int32), d2
