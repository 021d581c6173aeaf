"""IVF: inverted-file index over FastPQ codes (counterpart of
tinyknn_tpu/models/ivf.py: fit, build, the bucket-mode query and the
exact engine).

Coarse k-means clustering; each point is placed in its ``n_probes``
nearest lists at build; a query scans its ``n_probes`` nearest lists
and rescores the best ``pass_1`` candidates exactly in fp32.

Layout and query pipeline are the JAX package's:

  * inverted lists are CSR-tiled: codes live in a flat tile array
    ``csr_codes[T, B_pad/2, 128]`` (nibble-packed blocks, points on the
    last axis) where list i owns ``ceil(len_i / 128)`` consecutive
    tiles starting at ``tile_offsets[i]``, with flat ids
    ``csr_ids[T * 128]`` (-1 = padding);
  * a batch's (query, probe) pairs are bucketed by list, so each list
    is scanned once per batch for every query that probes it
    (``_bucket_scan_round``) by the ``scan_fold_csr`` kernel, which
    emits an encoded min-fold per (list, query slot);
  * selection runs on the int32 encodings, and only the survivors are
    decoded, rescored, deduplicated (build_probes > 1) and cut to k.

The exact engine (``scan_impl='exact'``) keeps the same lists but also
a bf16 copy of every listed vector, augmented so that one dot product
with an augmented query is the true squared distance
(``csr_vecs[T, d_aug, 128]``); the ``scan_exact_csr`` kernel scans it
in place of the codes, and the same selection and rescore follow.

All state lives on the device given at construction. Not ported yet
(ROADMAP queue 1): gather mode, the 'xla' scan engine,
``rescore_rows``, ``query_stream`` and ``tune_n_probes``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import (
    ENC_INVALID,
    EXACT_MAX_POSITIONS,
    LANE_TILE,
    fold_encoding,
    pack_codes_tiled,
    permute_tables_csr,
    scan_exact_csr,
    scan_fold_csr,
)
from ..ops.kmeans import kmeans_fit
from ..ops.topk import dedup_candidates, smallest_k
from ..utils.bruteforce import fp32_matmuls, knn_brute
from ..utils.grouping import invert_assignments_csr_tiled
from ..utils.padding import round_up
from .fast_pq import FastPQ, _build_tables, as_f32

FOLD_MULT = 8       # fold-width headroom over r (see _fold_tiles)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tinyknn_tpu_torch yet: ROADMAP queue 1, "
        f"{item}")


class IVF:
    """Inverted-file ANN index with its state on ``device``."""

    def __init__(self, metric, n_clusters, pq=None, seed=0,
                 kmeans_iters=30, queries_per_cluster=None,
                 pass1_method="auto", scan_impl="auto",
                 fold_mult=FOLD_MULT, rescore_rows=False,
                 scan_budget_bytes=2 << 30, device="cpu"):
        """``scan_impl``: 'auto' and 'fused' both scan the PQ codes with
        the scan_fold_csr kernel; 'exact' scans bf16 vectors with
        scan_exact_csr (4x the memory of the codes at dims_per_block=2;
        lists of at most 65,536 points). ``pass1_method``: 'auto' and
        'exact' both select exactly (the card has no approx_max_k).
        ``device``: where
        the index and every query's work live; nothing picks it for you.

        ``scan_budget_bytes`` bounds the (C, qc, S) scan grids that the
        drop-retry escalation may grow into (see ``_qc_caps``).
        """
        if metric not in ("euclidean", "angular"):
            raise ValueError(f"metric must be euclidean or angular, not "
                             f"{metric!r}")
        _check_scan_impl(scan_impl)
        if pass1_method == "approx":
            raise _not_ported("pass1_method='approx'", "item 5")
        if pass1_method not in ("auto", "exact"):
            raise ValueError(f"unknown pass1_method {pass1_method!r}")
        if rescore_rows:
            raise _not_ported("rescore_rows=True", "item 5")
        self.device = torch.device(device)
        self.metric = metric
        self.pq = (FastPQ(dims_per_block=2, device=self.device)
                   if pq is None else pq)
        if self.pq.centers is not None:
            raise ValueError("PQ should not be pre-fitted")
        if self.pq.device != self.device:
            raise ValueError(f"pq lives on {self.pq.device}, the index on "
                             f"{self.device}")
        self.n_clusters = n_clusters
        self.seed = seed
        self.kmeans_iters = kmeans_iters
        self.queries_per_cluster = queries_per_cluster
        self.pass1_method = pass1_method
        self.scan_impl = scan_impl
        self.fold_mult = fold_mult
        self.rescore_rows = rescore_rows
        self.scan_budget_bytes = int(scan_budget_bytes)
        self.build_probes = None
        self.list_counts = None   # (C,) int32 true list lengths
        self.all_centers = None   # (n_clusters, d) f32
        self.active_centers = None  # (C, d) f32, the non-empty lists
        self.csr_codes = None     # (T, B_pad/2, 128) uint8 code tiles
        self.csr_ids = None       # (T * 128,) int32, -1 padding
        self.csr_vecs = None      # (T, d_aug, 128) bf16 (exact engine)
        self.tile_offsets = None  # (C,) int32, list i starts at tile [i]
        self.max_tiles = None     # host int: longest list in tiles
        self.data = None          # (n, d) f32 (normalized when angular)
        self.labels = None        # optional (n,) int64 user labels

    # --------------------------------------------------------------- fit

    def fit(self, X, verbose=False):
        """Coarse clustering + PQ codebook fit."""
        fp32_matmuls()
        X = as_f32(X, self.device)
        if X.shape[0] < 1:
            raise ValueError("Can't fit no data")
        if self.metric == "angular":
            X = X / torch.linalg.norm(X, dim=1, keepdim=True)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        centers, _ = kmeans_fit(X, min(self.n_clusters, X.shape[0]),
                                generator=gen, iters=self.kmeans_iters,
                                n_init=1)
        if self.metric == "angular":
            norms = torch.linalg.norm(centers, dim=1, keepdim=True)
            centers = centers / norms.clamp(min=1e-12)
        self.all_centers = centers
        self.pq.fit(X, verbose=verbose)
        return self

    # ------------------------------------------------------------- build

    def build(self, X, n_probes=2, labels=None, verbose=False):
        """Place every point in its ``n_probes`` nearest lists and
        encode it. ``labels``: optional (n,) int64 user labels that
        queries return in place of row numbers."""
        del verbose
        if self.all_centers is None:
            raise RuntimeError(
                "IVF has not been fitted: call fit(X) before build(X)")
        if n_probes > self.n_clusters:
            raise ValueError(f"Can't assign points to {n_probes} clusters, "
                             f"as index only has {self.n_clusters}")
        data = as_f32(X, self.device)
        if data.shape[0] >= 2**31:
            raise ValueError("corpus capped at 2^31 rows (int32 ids)")
        self.labels = None
        if labels is not None:
            labels = torch.as_tensor(np.asarray(labels).reshape(-1),
                                     dtype=torch.int64, device=self.device)
            if labels.shape[0] != data.shape[0]:
                raise ValueError("labels must have one entry per data row")
            self.labels = labels
        if self.metric == "angular":
            norms = torch.linalg.norm(data, dim=1, keepdim=True)
            data = data / norms.clamp(min=1e-30)
        self.data = data
        self.build_probes = min(n_probes, self.all_centers.shape[0])
        nearest = knn_brute(data, self.all_centers, k=self.build_probes,
                            metric=self.metric).cpu().numpy()
        active = np.unique(nearest)
        remap = np.full(self.all_centers.shape[0], -1, dtype=np.int64)
        remap[active] = np.arange(len(active))
        self.active_centers = self.all_centers[
            torch.as_tensor(active, device=self.device)]
        _, codes = self.pq.transform(data)
        flat_ids, toff, counts = invert_assignments_csr_tiled(
            remap[nearest], len(active), tile=LANE_TILE)
        csr_ids = torch.as_tensor(flat_ids, device=self.device)
        self._set_lists(pack_codes_tiled(codes, csr_ids), csr_ids, toff,
                        counts)
        self.csr_vecs = None
        return self.set_scan_impl(self.scan_impl)

    def set_scan_impl(self, scan_impl):
        """Switch the list-scan engine of a built index. The exact
        engine's vector tiles are derived from (data, csr_ids): they are
        built here when it is switched on and freed when it is switched
        off, so archives do not depend on the engine."""
        _check_scan_impl(scan_impl)
        if (scan_impl == "exact" and self.csr_vecs is None
                and self.csr_ids is not None):
            if self.max_tiles * LANE_TILE > EXACT_MAX_POSITIONS:
                raise ValueError(
                    f"exact mode: the longest list ({self.max_tiles} tiles) "
                    f"exceeds the 16-bit fold position field; raise "
                    f"n_clusters")
            self.csr_vecs = _augment_data_csr(self.data, self.csr_ids)
        elif scan_impl != "exact":
            self.csr_vecs = None
        self.scan_impl = scan_impl
        return self

    def _set_lists(self, csr_codes, csr_ids, tile_offsets, counts):
        """Install the CSR lists (tile_offsets, counts: host arrays)."""
        dev = self.device
        self.csr_codes = torch.as_tensor(csr_codes, device=dev)
        self.csr_ids = torch.as_tensor(csr_ids, dtype=torch.int32,
                                       device=dev)
        self.tile_offsets = torch.as_tensor(
            np.asarray(tile_offsets, np.int32), device=dev)
        self.list_counts = torch.as_tensor(np.asarray(counts, np.int32),
                                           device=dev)
        self.max_tiles = max(1, int(-(-int(np.max(counts, initial=0))
                                      // LANE_TILE)))

    # ------------------------------------------------------------- query

    def query(self, q, k, n_probes=1, pass_1=None, mode="auto",
              with_stats=False):
        """Top-k ids for one query (d,) or a (Q, d) batch.

        Returns an int32 tensor on the index's device, (k,) or (Q, k)
        (int64 when the index has labels); slots that found no valid
        candidate hold -1. ``mode``: 'bucket' or 'auto' (which is
        bucket here). ``with_stats=True`` also returns a diagnostics
        dict (probe pairs dropped by the bucket capacity, the
        capacities used).

        A skewed batch (many queries near one list) can overflow the
        per-list bucket capacity; the query then retries at 4x the
        capacity and last at the can't-drop caps, as the JAX package
        does. ``queries_per_cluster`` pins the capacity and turns the
        retries off.
        """
        if self.csr_codes is None:
            raise RuntimeError(
                "IVF index is empty: call fit(X) and build(X) before query")
        if mode == "gather":
            raise _not_ported("mode='gather'", "item 11")
        if mode not in ("auto", "bucket"):
            raise ValueError(f"unknown mode {mode!r}")
        fp32_matmuls()
        q = as_f32(q, self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        k, n_probes, pass_1, r, r_tail, qc, qc0 = _query_params(
            self, q.shape[0], k, n_probes, pass_1)
        exact = self.scan_impl == "exact"
        if not exact:
            B_pad = 2 * round_up(self.pq.center_blocks.shape[0] // 2, 8)
            table_dtype = (torch.int8 if self.pq.table_dtype == "int8"
                           else torch.bfloat16)
            try:
                fold_encoding(table_dtype, B_pad, self.max_tiles)
            except ValueError as e:
                raise _not_ported(
                    f"{e}: the JAX package scans such lists with "
                    f"scan_impl='xla', which", "item 5") from e
        attempts = 1 if self.queries_per_cluster else 3
        qc_full, qc0_full = _qc_caps(self, q.shape[0], n_probes, r, r_tail,
                                     qc, qc0)
        for attempt in range(attempts):
            out, dropped = _ivf_query(
                q, self.pq, self.active_centers,
                self.csr_vecs if exact else self.csr_codes,
                self.csr_ids, self.tile_offsets, self.list_counts,
                self.data, metric=self.metric, k=k, n_probes=n_probes,
                pass_1=pass_1, r=r, r_tail=r_tail, qc=qc, qc0=qc0,
                max_tiles=self.max_tiles, build_probes=self.build_probes,
                fold_mult=self.fold_mult, exact=exact)
            dropped = int(dropped)
            if attempt + 1 == attempts or dropped == 0:
                break
            if attempt + 2 == attempts:  # last try: can't-drop caps
                qc, qc0 = qc_full, qc0_full
            else:
                qc = min(round_up(4 * qc, 8), qc_full)
                qc0 = min(round_up(4 * qc0, 8), qc0_full)
        out = out[0] if single else out
        if self.labels is not None:
            out = torch.where(out >= 0, self.labels[out.clamp(min=0).long()],
                              -1)
        if with_stats:
            return out, {
                "mode": "bucket",
                "dropped_probe_pairs": dropped,
                "total_probe_pairs": int(q.shape[0]) * n_probes,
                "queries_per_cluster_cap": qc,
                "queries_per_cluster_cap_round0": qc0,
                "pass_1": pass_1,
                "per_pair_candidates": (r, r_tail),
            }
        return out


def _check_scan_impl(scan_impl):
    if scan_impl == "xla":
        raise _not_ported("scan_impl='xla'", "item 5")
    if scan_impl not in ("auto", "fused", "exact"):
        raise ValueError(f"unknown scan_impl {scan_impl!r}")


def _aug_dim(d: int) -> int:
    """Width of the exact engine's augmented vectors:
    [x (d) | hi(|x|^2) | lo(|x|^2) | 1], padded to a multiple of 16."""
    return round_up(d + 3, 16)


def _augment_data_csr(data, flat_ids):
    """Raw vectors -> the exact engine's CSR tile layout.

    data: f32[n, d] (normalized already for angular); flat_ids:
    int32[T * 128] CSR row ids (padding reuses row 0, masked by the list
    counts). Returns bf16[T, d_aug, 128]: points on the last axis,
    augmented dimensions [x, hi(|x|^2), lo(|x|^2), 1, 0...] on the
    middle one. The norm rides as a two-term bf16 split (~16
    significant bits), so with the query side's [-2q, 1, 1, |q|^2] one
    dot product gives the true squared distance."""
    d = data.shape[1]
    rows = data[flat_ids.clamp(min=0).long()]             # (T*128, d) f32
    xn = torch.einsum("nd,nd->n", rows, rows)
    hi = xn.to(torch.bfloat16).to(torch.float32)
    aug = torch.zeros((rows.shape[0], _aug_dim(d)), dtype=torch.float32,
                      device=data.device)
    aug[:, :d] = rows
    aug[:, d] = hi
    aug[:, d + 1] = xn - hi
    aug[:, d + 2] = 1.0
    T = flat_ids.shape[0] // LANE_TILE
    return (aug.to(torch.bfloat16).reshape(T, LANE_TILE, -1)
            .transpose(1, 2).contiguous())


def _augment_queries(q):
    """f32[Q, d] -> bf16[Q, d_aug] in the exact engine's query layout
    [-2q, 1, 1, |q|^2, 0...]. |q|^2 rides in one bf16 slot: its rounding
    is the same for every point of a query, so it cannot change the
    ranking."""
    d = q.shape[1]
    qn = torch.einsum("qd,qd->q", q, q)
    aug = torch.zeros((q.shape[0], _aug_dim(d)), dtype=torch.float32,
                      device=q.device)
    aug[:, :d] = -2.0 * q
    aug[:, d] = 1.0
    aug[:, d + 1] = 1.0
    aug[:, d + 2] = qn
    return aug.to(torch.bfloat16)


def _fold_tiles(r: int, max_tiles: int, mult: int = FOLD_MULT) -> int:
    """Fold width in 128-lane tiles: ``mult``x headroom over r keeps
    position-class collisions (the fold's approximation) rare; never
    wider than the longest list."""
    return max(1, min(max_tiles, -(-mult * r // LANE_TILE)))


def default_qc0(Q: int, C: int) -> int:
    """Round-0 bucket capacity: ~2.5x the mean per-list load (round 0
    scans each query's nearest list, exactly one pair per query)."""
    return max(32, -(-5 * Q // (2 * C)) // 8 * 8 + 8)


def _exact_widths(mult, max_tiles, n_active, qc, qc0, k, pass_1,
                  n_probes=1):
    """Exact-engine fold widths: (r, r_tail, pass_1) such that
    _fold_tiles(r) folds round 0 over the whole longest list when the
    (C, qc0, S) grid stays under ~512 MB, and the tail rounds over a
    narrower budgeted fold. pass_1 is the rescore sliver, 4 k P by
    default (near-ties at the selection boundary grow with the number
    of scanned lists), never below k."""
    b0_tiles = max(1, (512 << 20)
                   // (4 * max(n_active, 1) * qc0 * LANE_TILE))
    bt_tiles = max(1, (512 << 20)
                   // (4 * max(n_active, 1) * qc * LANE_TILE))
    base = max(pass_1 if pass_1 is not None else 4 * k * max(n_probes, 1),
               k)
    w0 = max(min(max_tiles, b0_tiles),
             -(-mult * max(4 * k, 32) // LANE_TILE))
    wt = max(min(max_tiles, bt_tiles,
                 -(-mult * max(base, 2 * k) // LANE_TILE)),
             -(-mult * 16 // LANE_TILE))
    return (-(-w0 * LANE_TILE // mult), -(-wt * LANE_TILE // mult),
            base)


def _query_params(self, Q, k, n_probes, pass_1):
    """(k, n_probes, pass_1, r, r_tail, qc, qc0) for a batch of Q.

    r: per-pair candidate depth of each query's nearest list; r_tail:
    the shallower depth of its other probes; qc/qc0: bucket capacities
    (query slots per list) of the tail rounds and of round 0. In the
    exact engine r and r_tail only set the fold widths (see
    ``_exact_widths``): exact distances need no depth against estimate
    noise, but two of a list's top-k in one fold class lose one."""
    n_active = self.active_centers.shape[0]
    n_probes = min(n_probes, n_active)
    k = min(k, int(self.data.shape[0]))
    cap = self.max_tiles * LANE_TILE
    qc = self.queries_per_cluster or max(
        8, round_up(5 * Q * n_probes // (2 * max(n_active, 1)) + 1, 8))
    qc0 = self.queries_per_cluster or default_qc0(Q, n_active)
    if self.scan_impl == "exact":
        r, r_tail, pass_1 = _exact_widths(
            self.fold_mult or FOLD_MULT, self.max_tiles, n_active, qc, qc0,
            k, pass_1, n_probes=n_probes)
        return k, n_probes, pass_1, r, r_tail, qc, qc0
    if pass_1 is None:
        pass_1 = (n_probes + 1) * k + 1
    pass_1 = max(pass_1, k)  # p1 feeds a final top-k
    r = min(pass_1, cap)
    r_tail = min(pass_1, cap, max(3 * k, 16))
    pass_1 = min(pass_1, r + (n_probes - 1) * r_tail)
    return k, n_probes, pass_1, r, r_tail, qc, qc0


def _qc_caps(self, Q, n_probes, r, r_tail, qc, qc0):
    """Can't-drop bucket capacities for the drop-retry escalation,
    bounded by ``scan_budget_bytes`` of (C, qc, S) int32 fold grid."""
    n_active = self.active_centers.shape[0]
    s0_w = _fold_tiles(r, self.max_tiles, self.fold_mult) * LANE_TILE
    st_w = _fold_tiles(r_tail, self.max_tiles, self.fold_mult) * LANE_TILE
    budget = self.scan_budget_bytes
    qc_cap = max(qc, budget // max(1, 4 * n_active * st_w))
    qc0_cap = max(qc0, budget // max(1, 4 * n_active * s0_w))
    qc_full = min(round_up(Q * n_probes, 8), round_up(qc_cap, 8))
    qc0_full = min(round_up(Q, 8), round_up(qc0_cap, 8))
    return qc_full, qc0_full


def _bucket_scan_round(probe_sub, tables_flat, csr_codes, tile_offsets,
                       list_counts, qc: int, r: int, max_tiles: int,
                       fold_mult: int, exact: bool = False):
    """One bucketed scan round over a probe subset.

    probe_sub: (Q, Ps) list ids. Buckets the (query, probe) pairs by
    list (stable sort + position in run, capacity ``qc`` per list),
    scans every list once for all its queries with ``scan_fold_csr``
    (or, ``exact``, with ``scan_exact_csr``: tables_flat then holds the
    augmented queries and csr_codes the vector tiles) and hands each
    pair its fold row. Returns ``(enc int32[Q, Ps, S],
    rowbase int64[Q, Ps], dropped)``: the encoded pool, each pair's
    first flat row, and the count of pairs that overflowed a bucket.
    """
    Q, Ps = probe_sub.shape
    C = tile_offsets.shape[0]
    dev = probe_sub.device
    pairs = probe_sub.reshape(-1)
    q_of_pair = torch.arange(Q * Ps, device=dev) // Ps
    order = torch.argsort(pairs, stable=True)
    sorted_c = pairs[order]
    sorted_q = q_of_pair[order]
    pos = torch.arange(Q * Ps, device=dev)
    is_start = torch.ones_like(sorted_c, dtype=torch.bool)
    is_start[1:] = sorted_c[1:] != sorted_c[:-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    slot = pos - run_start                            # position within run
    in_cap = slot < qc
    # scatter query ids into the (C, qc) grid; overflowing pairs land in
    # a spare row C that is cut off (the JAX version drops them)
    qgrid = torch.full((C + 1, qc), -1, dtype=torch.int64, device=dev)
    qgrid[torch.where(in_cap, sorted_c, C), slot.clamp(max=qc - 1)] = sorted_q
    qgrid = qgrid[:C]
    slot_orig = torch.empty_like(slot).scatter_(0, order, slot).reshape(Q, Ps)

    t_sel = tables_flat[qgrid.clamp(min=0)]           # (C, qc, M)
    scan = scan_exact_csr if exact else scan_fold_csr
    enc = scan(t_sel, csr_codes, tile_offsets, list_counts,
               fold_tiles=_fold_tiles(r, max_tiles, fold_mult),
               max_tiles=max_tiles)                   # (C, qc, S)
    S = enc.shape[2]
    pair_idx = probe_sub * qc + slot_orig.clamp(max=qc - 1)
    my_enc = enc.reshape(C * qc, S)[pair_idx]         # (Q, Ps, S)
    my_enc = torch.where((slot_orig < qc)[:, :, None], my_enc, ENC_INVALID)
    rowbase = (tile_offsets.long() * LANE_TILE)[probe_sub.clamp(max=C - 1)]
    return my_enc, rowbase, (~in_cap).sum()


def _select_pool_enc(pools, bases, p1: int, col_bits: int, csr_ids):
    """Global candidate selection in the encoded int32 domain.

    pools: per-round encoded fold buffers [(Q, Ps_i, S_i) int32];
    bases: matching flat-row bases [(Q, Ps_i)]. Keeps the p1 smallest
    encodings per query (the encoding is monotone in the estimate, and
    its position bits break ties) and decodes only those. Returns
    (candidate ids int32[Q, p1], -1 = invalid).
    """
    Q = pools[0].shape[0]
    pool = torch.cat([p.reshape(Q, -1) for p in pools], dim=1)
    base = torch.cat(bases, dim=1)                    # (Q, P)
    enc_sel, top_pos = smallest_k(pool, p1)
    pos = enc_sel & ((1 << col_bits) - 1)
    S0 = pools[0].shape[1] * pools[0].shape[2]
    probe_of = torch.zeros_like(top_pos)
    if len(pools) > 1:
        St = pools[1].shape[2]
        probe_of = torch.where(top_pos < S0, 0,
                               1 + (top_pos - S0) // St)
    rows = torch.gather(base, 1, probe_of) + pos
    rows = rows.clamp(max=csr_ids.shape[0] - 1)
    valid = enc_sel < ENC_INVALID
    rows = torch.where(valid, rows, 0)
    return torch.where(valid, csr_ids[rows], -1)


def _ivf_query(q, pq, active_centers, csr_codes, csr_ids, tile_offsets,
               list_counts, data, *, metric: str, k: int, n_probes: int,
               pass_1: int, r: int, r_tail: int, qc: int, qc0: int,
               max_tiles: int, build_probes: int, fold_mult: int,
               exact: bool = False):
    """The batched IVF query: returns (ids (Q, k), dropped pairs).

    ``exact``: csr_codes holds the exact engine's vector tiles, stage 1
    augments the queries in place of building tables, and the scan runs
    ``scan_exact_csr``.

    Stages: (1) distance tables; (2) the P nearest lists by exact fp32
    distance to the active centers; (3) bucketed list scans in two
    rounds, each query's nearest list with per-pair depth r and the
    other probes with r_tail; (4) selection of the f * pass_1 smallest
    encodings, f = min(build_probes, n_probes) (a spilled point appears
    in up to f probed lists); (5) exact fp32 rescore, dedup when f > 1,
    top-k.
    """
    Q, d = q.shape
    P = n_probes
    if metric == "angular":
        q = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-12)
    if exact:
        tables_flat = _augment_queries(q)
    else:
        tables = _build_tables(q, pq.center_blocks, pq.R,
                               pq.dims_per_block, True, pq.table_dtype).tables
        B = tables.shape[1]
        tables_flat = permute_tables_csr(tables.reshape(Q, B * 16), B)
        if tables_flat.dtype == torch.float32:
            # the float fold encodes bf16 value bits; pre-round
            tables_flat = tables_flat.to(torch.bfloat16)

    # -- probe selection, exact fp32
    qn = torch.einsum("qd,qd->q", q, q)
    cn = torch.einsum("cd,cd->c", active_centers, active_centers)
    d2c = qn[:, None] + cn[None, :] - 2.0 * (q @ active_centers.T)
    _, probe_sel = smallest_k(d2c, P)                 # (Q, P)

    # -- scan rounds
    v0, rows0, dropped = _bucket_scan_round(
        probe_sel[:, :1], tables_flat, csr_codes, tile_offsets, list_counts,
        qc=qc0, r=r, max_tiles=max_tiles, fold_mult=fold_mult, exact=exact)
    pools, bases = [v0], [rows0]
    if P > 1:
        v1, rows1, drop1 = _bucket_scan_round(
            probe_sel[:, 1:], tables_flat, csr_codes, tile_offsets,
            list_counts, qc=qc, r=r_tail, max_tiles=max_tiles,
            fold_mult=fold_mult, exact=exact)
        pools.append(v1)
        bases.append(rows1)
        dropped = dropped + drop1

    # -- selection on the encodings
    f = min(build_probes, n_probes)
    width = sum(p.shape[1] * p.shape[2] for p in pools)
    p1 = min(f * pass_1, width)
    col_bits = 16 if exact else fold_encoding(
        tables_flat.dtype, tables_flat.shape[1] // 16, max_tiles)[0]
    cand = _select_pool_enc(pools, bases, p1, col_bits, csr_ids)

    # -- exact fp32 rescore (+ dedup of build-spill duplicates)
    diff = data[cand.clamp(min=0).long()] - q[:, None, :]  # (Q, p1, d)
    d2 = torch.einsum("qrd,qrd->qr", diff, diff)
    d2 = torch.where(cand >= 0, d2, float("inf"))
    if f > 1:
        _, best = smallest_k(d2, min(k * f, p1))
        cand = torch.gather(cand, 1, best)
        d2 = torch.gather(d2, 1, best)
        cand, d2 = dedup_candidates(cand, d2)
    out_d2, best = smallest_k(d2, k)
    out = torch.gather(cand, 1, best)
    return torch.where(torch.isfinite(out_d2), out, -1), dropped
