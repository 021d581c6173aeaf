"""IVF: inverted-file index over FastPQ codes (counterpart of
tinyknn_tpu/models/ivf.py).

Coarse k-means clustering; each point is placed in its ``n_probes``
nearest lists at build; a query scans its ``n_probes`` nearest lists
and rescores the best ``pass_1`` candidates exactly in fp32.

Layout and query pipeline are the JAX package's:

  * inverted lists are CSR-tiled: codes live in a flat tile array
    ``csr_codes[T, B_pad/2, 128]`` (nibble-packed blocks, points on the
    last axis) where list i owns ``ceil(len_i / 128)`` consecutive
    tiles starting at ``tile_offsets[i]``, with flat ids
    ``csr_ids[T * 128]`` (-1 = padding);
  * bucket mode (the throughput path): a batch's (query, probe) pairs
    are bucketed by list, so each list is scanned once per batch for
    every query that probes it (``_bucket_scan_round``), by the
    ``scan_fold_csr`` kernel, which emits an encoded min-fold per
    (list, query slot); selection runs on the int32 encodings, and only
    the survivors are decoded, rescored, deduplicated (build_probes > 1)
    and cut to k. ``scan_impl='xla'`` scans the same buckets in plain
    torch instead (dense one-hot products and a top-r per pair), for
    lists too long for the fold encoding;
  * pairs past a full bucket: ``query()``'s first pass scans up to one
    more bucket's worth of them per round in an overflow grid (the
    same kernel, one query slot per entry), in the same pass and with
    no host sync; only past that grid does it rerun the batch at 4x
    the capacities. ``query_stream``, a pinned ``queries_per_cluster``,
    the sharded index and 'xla' report their drops as the JAX package
    does;
  * gather mode (the latency path for small batches): each query
    gathers its probed lists and sums its own tables over them
    (``_ivf_query_gather``), with no bucketing and no kernel;
  * ``query_stream`` runs many batches per call at capacities measured
    once per shape from the stream's own per-list load.

The exact engine (``scan_impl='exact'``) keeps the same lists but also
a bf16 copy of every listed vector, augmented so that one dot product
with an augmented query is the true squared distance
(``csr_vecs[T, d_aug, 128]``); the ``scan_exact_csr`` kernel scans it
in place of the codes, and the same selection and rescore follow.
``rescore_rows`` keeps a CSR-ordered fp32 copy of the vectors so the
rescore reads by flat row and decodes ids for the winners only.

All state lives on the device given at construction. The sharded
index (``parallel.ShardedIVF``) runs the same scan rounds once per
shard, over the lists that shard owns.
"""

from __future__ import annotations

from typing import NamedTuple

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
from ..ops.packing import unpack_codes
from ..ops.topk import dedup_candidates, smallest_k
from ..utils.bruteforce import fp32_matmuls, knn_brute
from ..utils.grouping import invert_assignments_csr_tiled
from ..utils.padding import round_up
from ..utils.timing import counters, span
from .fast_pq import FastPQ, _build_tables, _resolve_method, as_f32

FOLD_MULT = 8       # fold-width headroom over r (see _fold_tiles)
GATHER_MAX_PAIRS = 64  # mode='auto' gathers when Q * n_probes is at most this
GROUP_SLOTS = 32    # query slots per grid list of _overflow_groups
# one-hot bytes per step of the 'xla' scan: the JAX package steps over
# CLUSTER_CHUNK = 8 lists; a byte budget bounds the step whatever the
# list length
XLA_CHUNK_BYTES = 256 << 20
SCAN_IMPLS = ("auto", "fused", "xla", "exact")


class IVF:
    """Inverted-file ANN index with its state on ``device``."""

    # ShardedIVF derives the exact engine's tiles and the raw rows per
    # shard when it places the lists; build() then skips the
    # single-device copies
    _sharded = False

    def __init__(self, metric, n_clusters, pq=None, seed=0,
                 kmeans_iters=30, queries_per_cluster=None,
                 pass1_method="auto", scan_impl="auto",
                 fold_mult=FOLD_MULT, rescore_rows=False,
                 scan_budget_bytes=2 << 30, device="cuda"):
        """``scan_impl``: 'fused' scans the PQ codes with the
        scan_fold_csr kernel; 'xla' scans them in plain torch (the JAX
        package's XLA engine: dense one-hot products, a top-r per pair);
        'auto' is 'fused' when the fold encoding holds the longest list
        and 'xla' otherwise; 'exact' scans bf16 vectors with
        scan_exact_csr (4x the memory of the codes at dims_per_block=2;
        lists of at most 65,536 points). ``pass1_method``: 'auto',
        'exact' and 'approx' all select exactly: the card has no
        approx_max_k, and the JAX package selects exactly off the TPU
        too. ``device``: where the index and every query's work live,
        the card unless the caller asks for the CPU; a machine without
        CUDA raises at the first allocation, with no fallback.

        ``rescore_rows``: keep a CSR-ordered fp32 copy of the vectors
        (T * 128 x d, one more copy of the data) so that the rescore
        reads by flat row and ids decode for the final winners only.
        The answers are the same with and without it.

        ``scan_budget_bytes`` bounds the (C, qc, S) scan grids that the
        drop-retry escalation and the stream's measured capacities may
        grow into (see ``_qc_caps``).
        """
        if metric not in ("euclidean", "angular"):
            raise ValueError(f"metric must be euclidean or angular, not "
                             f"{metric!r}")
        _check_scan_impl(scan_impl)
        _resolve_method(pass1_method)
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
        self.csr_raw = None       # (T * 128, d) f32 (rescore_rows)
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
        self.csr_vecs = self.csr_raw = None
        if self._sharded:
            return self
        return self.set_scan_impl(self.scan_impl).set_rescore_rows(
            self.rescore_rows)

    def set_scan_impl(self, scan_impl):
        """Switch the list-scan engine of a built index. The exact
        engine's vector tiles are derived from (data, csr_ids): they are
        built here when it is switched on and freed when it is switched
        off, so archives do not depend on the engine."""
        _check_scan_impl(scan_impl)
        if (scan_impl == "exact" and self.csr_vecs is None
                and self.csr_ids is not None):
            self._check_exact_fits()
            self.csr_vecs = _augment_data_csr(self.data, self.csr_ids)
        elif scan_impl != "exact":
            self.csr_vecs = None
        self.scan_impl = scan_impl
        return self

    def set_rescore_rows(self, enabled=True):
        """Switch the CSR-ordered raw-row copy of a built index on or
        off (see the constructor's ``rescore_rows``); it is derived from
        (data, csr_ids) like the exact engine's tiles."""
        self.rescore_rows = bool(enabled)
        if enabled and self.csr_raw is None and self.csr_ids is not None:
            self.csr_raw = _csr_raw_rows(self.data, self.csr_ids)
        if not enabled:
            self.csr_raw = None
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
        candidate hold -1. ``mode``: 'bucket' (the list-bucketed scan,
        the throughput path), 'gather' (each query gathers its probed
        lists: lower latency for small batches) or 'auto', which
        gathers when Q * n_probes <= 64. ``with_stats=True`` also
        returns a diagnostics dict (the mode run, probe pairs dropped by
        the bucket capacity, the capacities used).

        A skewed batch (many queries near one list) can overflow the
        per-list bucket capacity. The first pass scans the overflowing
        (query, probe) pairs of each scan round, up to one more (larger)
        bucket's worth, in an overflow grid of the same round, so a few
        overflows cost one small kernel launch and change no id. Only
        when that grid overflows too does the query retry, at 4x the
        capacity and last at the can't-drop caps, as the JAX package
        does. Where ``scan_budget_bytes`` clamps the caps below the
        fullest list, the JAX package drops the rest; here the last pass
        scans it in an overflow grid with room for every pair the pass
        before dropped. ``queries_per_cluster`` pins the capacity and
        turns all of this off: the drops are then reported, as by
        ``query_stream``.

        On the exact engine the default rescore sliver ``pass_1`` is
        4 * k * n_probes, linear in n_probes; pass an explicit
        ``pass_1`` (floored at k) to pin it.
        """
        with span("tinyknn.query"):
            self._check_built()
            if mode not in ("auto", "bucket", "gather"):
                raise ValueError(f"unknown mode {mode!r}")
            fp32_matmuls()
            with span("tinyknn.input"):
                q = as_f32(q, self.device)
            single = q.ndim == 1
            if single:
                q = q[None]
            params = _query_params(self, q.shape[0], k, n_probes, pass_1)
            k, n_probes, pass_1, r, r_tail, qc, qc0 = params
            if mode == "auto":
                mode = ("gather"
                        if q.shape[0] * n_probes <= GATHER_MAX_PAIRS
                        else "bucket")
            if mode == "gather":
                exact = self.scan_impl == "exact"
                self._check_exact()
                with span("tinyknn.gather"):
                    out = _ivf_query_gather(
                        q, self.pq, self.active_centers,
                        self.csr_vecs if exact else self.csr_codes,
                        self.csr_ids, self.tile_offsets, self.list_counts,
                        self.data, metric=self.metric, k=k,
                        n_probes=n_probes, pass_1=pass_1,
                        max_tiles=self.max_tiles, exact=exact)
                dropped = 0
            else:
                out, dropped, qc, qc0 = _query_with_retries(
                    self, q, params, q.shape[0],
                    rescue=(not self.queries_per_cluster
                            and self._scan_engine() != "xla"))
            out = self._map_labels(out[0] if single else out)
            if with_stats:
                return out, _query_stats(
                    dropped, int(q.shape[0]) * n_probes, qc, qc0, pass_1,
                    mode=mode, per_pair_candidates=(r, r_tail))
            return out

    def query_stream(self, batches, k, n_probes=1, pass_1=None,
                     with_stats=False, adaptive_qc=True, device_out=False):
        """Top-k ids for a (R, Q, d) stream of query batches: (R, Q, k)
        int32 (int64 with labels), in bucket mode.

        The R batches run one after another on the device's stream and
        the host waits once, at the end, for the ids and the summed
        count of dropped pairs. ``device_out=True`` waits for nothing:
        it returns ``(ids, dropped)`` as tensors on the index's device,
        positional int32 ids with no label mapping, for a caller whose
        next stage runs on the device; it cannot build the stats dict,
        and since the host never reads the drops, it adds none to
        ``counters["query.dropped_pairs"]`` or ``"query.lost_pairs"``
        (the R passes still count in ``counters["query.attempts"]``).

        There is no drop retry (it would rerun the whole stream).
        Instead, with ``adaptive_qc=True`` the first call at a
        (Q, n_probes) shape measures the stream's peak per-list load
        (the same probe selection, then a count per list) and raises
        the bucket capacities to cover it, clamped by
        ``scan_budget_bytes``; later calls reuse the floors. If a
        host-path call still drops pairs, the floors are measured again
        on that stream for the next call. ``queries_per_cluster`` pins
        the capacities and turns all of this off.

        ``with_stats=True`` also returns a dict: pairs dropped across
        the stream, the capacities and the floors applied.
        """
        with span("tinyknn.query_stream"):
            self._check_built()
            if device_out and with_stats:
                raise ValueError(
                    "device_out=True returns device tensors and cannot "
                    "build the host-side stats dict; audit drops on a "
                    "host-path call (with_stats=True, device_out=False)")
            fp32_matmuls()
            with span("tinyknn.input"):
                batches = as_f32(batches, self.device)
            if batches.ndim != 3:
                raise ValueError(f"batches must be (R, Q, d), not "
                                 f"{tuple(batches.shape)}")
            R, Q, _ = batches.shape
            q_view, view = self._batch_view(Q)
            adaptive = bool(adaptive_qc) and not self.queries_per_cluster
            params = _query_params(self, q_view, k, n_probes, pass_1, **view)
            floors, key, fresh = (0, 0), None, False
            if adaptive:
                params, floors, key, fresh = _stream_adaptive_params(
                    self, batches, k, n_probes, pass_1, params, Q=q_view,
                    **view)
            k, n_probes, pass_1, r, r_tail, qc, qc0 = params
            scan_impl = self._scan_engine()
            first = self._answer_device()
            dropped = torch.zeros((), dtype=torch.int64, device=first)
            outs = []
            for b in range(R):
                counters["query.attempts"] += 1
                out, drop = self._bucket_query(batches[b], params,
                                               scan_impl)
                outs.append(out)
                dropped = dropped + drop
            out = torch.stack(outs) if outs else torch.zeros(
                (0, Q, k), dtype=torch.int32, device=first)
            if device_out:
                return out, dropped
            with span("tinyknn.drop_check"):
                dropped = int(dropped)
            counters["query.dropped_pairs"] += dropped
            counters["query.lost_pairs"] += dropped
            if adaptive and dropped:
                _refresh_stream_floors(self, key, batches, n_probes,
                                       just_measured=fresh)
            out = self._map_labels(out.to(self.device))
            if with_stats:
                return out, _query_stats(
                    dropped, R * Q * n_probes, qc, qc0, pass_1,
                    adaptive_qc_floors=floors if adaptive else None)
            return out

    def _batch_view(self, Q: int):
        """``(Q, view)`` that size a batch of Q queries' capacities:
        ``_query_params``' ``Q`` and its ``n_active``/``n_probes_max``
        arguments. Here the whole batch over every active list; a
        sharded index sizes them per mesh position."""
        return Q, {}

    def _answer_device(self):
        """Where ``_bucket_query`` leaves a batch's ids and drop count."""
        return self.device

    def _check_built(self):
        if self.csr_codes is None:
            raise RuntimeError(
                "IVF index is empty: call fit(X) and build(X) before query")

    def _check_exact_fits(self):
        if self.max_tiles * LANE_TILE > EXACT_MAX_POSITIONS:
            raise ValueError(
                f"exact mode: the longest list ({self.max_tiles} tiles) "
                f"exceeds the 16-bit fold position field; raise n_clusters")

    def _check_exact(self):
        if self.scan_impl == "exact" and self.csr_vecs is None:
            raise RuntimeError(
                "exact mode needs the vector tiles: switch engines with "
                "set_scan_impl('exact'), not by assignment")

    def _scan_engine(self) -> str:
        """The bucket-mode engine: 'exact', 'xla', or 'fused'. 'auto' is
        'fused' when the fold encoding holds the longest list and 'xla'
        otherwise (the JAX package's ``_fused_ok`` less its VMEM test,
        which has no counterpart on the card); an explicit 'fused' on
        such a list raises the encoding's ValueError."""
        self._check_exact()
        if self.scan_impl in ("exact", "xla"):
            return self.scan_impl
        B_pad = 2 * round_up(self.pq.center_blocks.shape[0] // 2, 8)
        table_dtype = (torch.int8 if self.pq.table_dtype == "int8"
                       else torch.bfloat16)
        try:
            fold_encoding(table_dtype, B_pad, self.max_tiles)
        except ValueError:
            if self.scan_impl == "fused":
                raise
            return "xla"
        return "fused"

    def _bucket_query(self, q, params, scan_impl, grid=None):
        """One bucket-mode batch: (ids (Q, k), dropped pairs tensor);
        ``grid``: ``_ivf_query``'s overflow grids, room for that many
        dropped pairs a round, whose drops are int64[2] (still dropped,
        rescued)."""
        k, n_probes, pass_1, r, r_tail, qc, qc0 = params
        return _ivf_query(
            q, self.pq, self.active_centers,
            self.csr_vecs if scan_impl == "exact" else self.csr_codes,
            self.csr_ids, self.tile_offsets, self.list_counts, self.data,
            self.csr_raw, metric=self.metric, k=k, n_probes=n_probes,
            pass_1=pass_1, r=r, r_tail=r_tail, qc=qc, qc0=qc0,
            max_tiles=self.max_tiles, build_probes=self.build_probes,
            fold_mult=self.fold_mult, scan_impl=scan_impl, grid=grid)

    def _map_labels(self, out):
        """Positional ids -> user labels (-1 stays -1), on the device."""
        if self.labels is None:
            return out
        return torch.where(out >= 0, self.labels[out.clamp(min=0).long()],
                           -1)


def _check_scan_impl(scan_impl):
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(f"unknown scan_impl {scan_impl!r}")


def _csr_raw_rows(data, flat_ids):
    """CSR-ordered copy of the raw rows (padding slots reuse row 0; they
    are masked by validity wherever the copy is read)."""
    return data[flat_ids.clamp(min=0).long()]


def _tiles_to_dense(csr_tiles, tile_offsets, max_tiles: int):
    """Each list's ``max_tiles`` tiles from ``tile_offsets`` as a dense
    (..., max_tiles * 128, X) view of the [T, X, 128] tiles
    (tile_offsets of any shape (...,); reads past a list run into the
    next one and are masked by the counts downstream)."""
    T = csr_tiles.shape[0]
    idx = (tile_offsets[..., None].long()
           + torch.arange(max_tiles, device=csr_tiles.device)).clamp(
               max=T - 1)
    tiles = csr_tiles[idx].transpose(-1, -2)          # (..., mt, 128, X)
    return tiles.reshape(tiles.shape[:-3]
                         + (max_tiles * LANE_TILE, tiles.shape[-1]))


def _rows_of(tile_offsets, cap: int, n_rows: int):
    """Flat rows (..., cap) of each list's slots (clipped to the last
    row; slots past a list's end are masked by the counts)."""
    rows = ((tile_offsets.long() * LANE_TILE)[..., None]
            + torch.arange(cap, device=tile_offsets.device))
    return rows.clamp(max=n_rows - 1)


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


def _query_params(self, Q, k, n_probes, pass_1, qc_min=0, qc0_min=0,
                  n_active=None, n_probes_max=None):
    """(k, n_probes, pass_1, r, r_tail, qc, qc0) for a batch of Q.

    r: per-pair candidate depth of each query's nearest list; r_tail:
    the shallower depth of its other probes; qc/qc0: bucket capacities
    (query slots per list) of the tail rounds and of round 0. In the
    exact engine r and r_tail only set the fold widths (see
    ``_exact_widths``): exact distances need no depth against estimate
    noise, but two of a list's top-k in one fold class lose one.

    ``qc_min``/``qc0_min``: capacity floors from a measured per-list
    load (the stream's pre-pass); they raise the mean-load sizing and
    never lower it, and a ``queries_per_cluster`` pin overrides both.
    ``n_active``: the list count the capacities and fold budgets are
    sized against (default: the index's active lists).
    ``n_probes_max``: the probe clamp (default: the same count)."""
    if n_active is None:
        n_active = self.active_centers.shape[0]
    n_probes = min(n_probes, n_probes_max if n_probes_max is not None
                   else self.active_centers.shape[0])
    k = min(k, int(self.data.shape[0]))
    cap = self.max_tiles * LANE_TILE
    qc = self.queries_per_cluster or max(
        8, round_up(5 * Q * n_probes // (2 * max(n_active, 1)) + 1, 8),
        qc_min)
    qc0 = self.queries_per_cluster or max(default_qc0(Q, n_active),
                                          qc0_min)
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


def _query_with_retries(self, q, params, Q: int, rescue: bool = False,
                        **view):
    """``query()``'s bucket-mode attempts: ``self._bucket_query`` on the
    batch ``q``; while pairs were dropped, again at 4x the capacities and
    last at the can't-drop caps (one attempt when ``queries_per_cluster``
    pins them). ``rescue`` (``IVF.query`` asks for it on the engines
    'fused' and 'exact' with capacities not pinned): the first attempt
    scans each round's overflowing pairs, up to the larger capacity's
    worth, in an overflow grid, so it retries only when that grid
    overflowed too; the last attempt scans its own in a grid with room
    for every pair that the attempt before it dropped (the caps are no
    lower than that attempt's capacities), so that it drops nothing
    where ``scan_budget_bytes`` clamps the caps below the fullest
    list. ``Q`` and ``view`` are
    ``_batch_view``'s. Returns ``(ids, dropped pairs, qc, qc0)`` of the
    last attempt; its drops also count in ``query.lost_pairs``."""
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    scan_impl = self._scan_engine()
    attempts = 1 if self.queries_per_cluster else 3
    qc_full, qc0_full = _qc_caps(self, Q, n_probes, r, r_tail, qc, qc0,
                                 n_active=view.get("n_active"))
    grid = max(qc, qc0) if rescue else None   # a pass's room a round
    for attempt in range(attempts):
        counters["query.attempts"] += 1
        params = (k, n_probes, pass_1, r, r_tail, qc, qc0)
        with span("tinyknn.retry" if attempt else "tinyknn.attempt"):
            out, drops = self._bucket_query(q, params, scan_impl, grid)
        with span("tinyknn.drop_check"):
            # a grid's drops are int64[2]: (still dropped, rescued)
            dropped, rescued = (drops.tolist() if grid is not None
                                else (int(drops), 0))
        counters["query.dropped_pairs"] += dropped
        counters["query.rescued_pairs"] += rescued
        if attempt + 1 == attempts or dropped == 0:
            break
        if attempt + 2 == attempts:  # last try: can't-drop caps
            qc, qc0 = qc_full, qc0_full
            grid = dropped if rescue else None
        else:
            qc = min(round_up(4 * qc, 8), qc_full)
            qc0 = min(round_up(4 * qc0, 8), qc0_full)
            grid = None
    if dropped:  # the last pass's drops: no answer scanned them
        counters["query.lost_pairs"] += dropped
    return out, dropped, qc, qc0


def _query_stats(dropped: int, pairs: int, qc: int, qc0: int, pass_1: int,
                 **more) -> dict:
    """The diagnostics dict of ``query`` and ``query_stream``."""
    return {"dropped_probe_pairs": dropped, "total_probe_pairs": pairs,
            "queries_per_cluster_cap": qc,
            "queries_per_cluster_cap_round0": qc0, "pass_1": pass_1, **more}


def _qc_caps(self, Q, n_probes, r, r_tail, qc, qc0, n_active=None):
    """Can't-drop bucket capacities for the drop-retry escalation,
    bounded by ``scan_budget_bytes`` of (C, qc, S) int32 fold grid.
    ``n_active``: the list count to size against (default: the
    index's active lists)."""
    if n_active is None:
        n_active = self.active_centers.shape[0]
    s0_w = _fold_tiles(r, self.max_tiles, self.fold_mult) * LANE_TILE
    st_w = _fold_tiles(r_tail, self.max_tiles, self.fold_mult) * LANE_TILE
    budget = self.scan_budget_bytes
    qc_cap = max(qc, budget // max(1, 4 * n_active * st_w))
    qc0_cap = max(qc0, budget // max(1, 4 * n_active * s0_w))
    qc_full = min(round_up(Q * n_probes, 8), round_up(qc_cap, 8))
    qc0_full = min(round_up(Q, 8), round_up(qc0_cap, 8))
    return qc_full, qc0_full


# ------------------------------------------------------ stream capacities


def _stream_adaptive_params(self, batches, k_arg, p_arg, p1_arg, params,
                            Q=None, n_active=None, n_probes_max=None):
    """The stream's bucket capacities: the peak per-list load, measured
    once per (Q, n_probes) shape and cached in ``_stream_qc_floors``,
    clamped by the same budget as the drop-retry caps, and injected into
    ``_query_params`` as floors. Returns ``(params, floors applied,
    cache key, measured_now)``; ``measured_now`` tells the caller the
    floors come from this very stream, so that a drop can only be the
    budget clamp. ``Q``/``n_active``/``n_probes_max`` are
    ``_query_params``' views; the floors are also clamped by ``Q``."""
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    if Q is None:
        Q = batches.shape[1]
    cache = getattr(self, "_stream_qc_floors", None)
    if cache is None:
        cache = self._stream_qc_floors = {}
    key = (Q, n_probes)
    measured_now = key not in cache
    if measured_now:
        m0, mt = _stream_peak_loads(batches, self.active_centers,
                                    n_probes=n_probes, metric=self.metric)
        cache[key] = (_qc_bucket(m0), _qc_bucket(mt))
    floors = cache[key]
    if floors[0] > qc0 or floors[1] > qc:
        qc_full, qc0_full = _qc_caps(self, Q, 1, r, r_tail, qc, qc0,
                                     n_active=n_active)
        f0 = min(floors[0], qc0_full)
        ft = min(floors[1], qc_full)
        params = _query_params(self, Q, k_arg, p_arg, p1_arg,
                               qc_min=ft, qc0_min=f0, n_active=n_active,
                               n_probes_max=n_probes_max)
        floors = (f0, ft)   # what the scan runs at, clamp included
    return params, floors, key, measured_now


def _refresh_stream_floors(self, key, batches, n_probes,
                           just_measured=False):
    """A host-path stream dropped pairs despite its measured floors.
    Either the queries drifted since the floors were measured (measure
    again on this stream, so the next same-shape stream is clean), or
    the budget clamp holds the capacity below the true peak (measuring
    again returns the same floors: mark the (shape, budget) final in
    ``_stream_floor_final`` and stop measuring). ``just_measured``: the
    floors come from this stream, so it can only be the clamp."""
    final = getattr(self, "_stream_floor_final", None)
    if final is None:
        final = self._stream_floor_final = set()
    fkey = (key, self.scan_budget_bytes)
    if fkey in final:
        return
    if just_measured:
        final.add(fkey)
        return
    m0, mt = _stream_peak_loads(batches, self.active_centers,
                                n_probes=n_probes, metric=self.metric)
    floors = (_qc_bucket(m0), _qc_bucket(mt))
    if floors == self._stream_qc_floors.get(key):
        final.add(fkey)
    self._stream_qc_floors[key] = floors


def _qc_bucket(n: int) -> int:
    """A measured per-list load rounded up to a power-of-two capacity
    (>= 8), so capacities move in coarse steps."""
    if n <= 0:
        return 0
    return max(8, 1 << (int(n) - 1).bit_length())


def _stream_peak_loads(batches, active_centers, *, n_probes: int,
                       metric: str):
    """Host ints (round-0 peak, tail peak): the most (query, probe)
    pairs any list receives in one batch of the stream, split into each
    query's nearest list and its other probes, the loads qc0 and qc
    must cover. The probe selection is ``_ivf_query``'s own, batch by
    batch at the same shapes, so the counted loads are the scan's."""
    C = active_centers.shape[0]
    dev = active_centers.device
    peaks = torch.zeros(2, dtype=torch.int64, device=dev)
    for q in batches:
        sel = _probe_select(_normalize(q, metric), active_centers, n_probes)
        for i, lists in enumerate((sel[:, 0], sel[:, 1:].reshape(-1))):
            load = torch.zeros(C, dtype=torch.int64, device=dev).scatter_add_(
                0, lists, torch.ones_like(lists))
            peaks[i] = torch.maximum(peaks[i], load.max())
    m0, mt = peaks.tolist()
    return m0, mt


# --------------------------------------------------------- bucket mode


def _normalize(q, metric: str):
    if metric == "angular":
        return q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-12)
    return q


def _probe_select(q, active_centers, P: int):
    """(Q, P) nearest lists by exact fp32 distance to the active
    centers, nearest first, ties to the lower list."""
    qn = torch.einsum("qd,qd->q", q, q)
    cn = torch.einsum("cd,cd->c", active_centers, active_centers)
    d2c = qn[:, None] + cn[None, :] - 2.0 * (q @ active_centers.T)
    return smallest_k(d2c, P)[1]


def _bucket_pairs(probe_sub, C: int, qc: int):
    """Bucket the (query, probe) pairs of ``probe_sub`` (Q, Ps) by list:
    stable sort, position in run, capacity ``qc`` per list. Returns
    ``(qgrid int64[C, qc] query per slot (-1 empty), pair_idx
    int64[Q, Ps] each pair's row of the (C * qc) grid, in_slot
    bool[Q, Ps], dropped)``: pairs past a full bucket are dropped and
    counted.

    A list id >= C is a sentinel (the sharded index sends every pair
    whose list another shard owns to id C): such a pair takes no slot,
    is never counted as dropped, and its ``pair_idx`` is clamped to the
    grid's last row, so what it reads there is the caller's to mask."""
    Q, Ps = probe_sub.shape
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
    real = sorted_c < C
    # scatter query ids into the (C, qc) grid; overflowing and sentinel
    # pairs land in a spare row C that is cut off (the JAX version drops
    # them)
    qgrid = torch.full((C + 1, qc), -1, dtype=torch.int64, device=dev)
    qgrid[torch.where(in_cap & real, sorted_c, C),
          slot.clamp(max=qc - 1)] = sorted_q
    slot_orig = torch.empty_like(slot).scatter_(0, order, slot).reshape(Q, Ps)
    pair_idx = (probe_sub * qc + slot_orig.clamp(max=qc - 1)).clamp(
        max=C * qc - 1)
    return qgrid[:C], pair_idx, slot_orig < qc, (~in_cap & real).sum()


def _bucket_scan_round(probe_sub, tables_flat, csr_codes, tile_offsets,
                       list_counts, qc: int, r: int, max_tiles: int,
                       fold_mult: int, scan_impl: str = "fused",
                       n_blocks: int | None = None,
                       grid: int | None = None):
    """One bucketed scan round over a probe subset.

    probe_sub: (Q, Ps) list ids. Scans every list once for all its
    bucketed queries and hands each pair its share. An id equal to the
    list count is a sentinel (see ``_bucket_pairs``): nothing is scanned
    for it and the caller masks its row.

    'fused' runs ``scan_fold_csr`` ('exact': ``scan_exact_csr``, with
    tables_flat the augmented queries and csr_codes the vector tiles)
    and returns ``(enc int32[Q, Ps, S], rowbase int64[Q, Ps],
    dropped)``: each pair's encoded fold row and its list's first flat
    row. 'xla' returns ``(vals f32[Q, Ps, r], rows int64[Q, Ps, r],
    dropped)``: each pair's r smallest estimates (+inf = no candidate)
    and their flat rows. 'fused' and 'exact' hand their kernel each
    list's occupied slot count, counted on the device, so it scans no
    empty slot; 'fused' also hands K1 ``n_blocks``, the real table block
    count, so it skips the pad blocks.

    ``grid`` ('fused' and 'exact'): the first ``grid`` pairs that found
    their bucket full are scanned in the same round by a second launch
    of the kernel over an overflow grid, and their fold rows take the
    place of the dropped rows. Where the round's drops may lie one a
    list (a first pass's few overflows), the grid holds one pair a grid
    list (``_overflow_grid``); where they can only crowd, two or more a
    list on average (the caps pass, past caps that ``scan_budget_bytes``
    clamps), up to ``GROUP_SLOTS`` pairs of one list a grid list
    (``_overflow_groups``), so that the kernel reads such a list once
    for that many pairs. Each form is the cheaper in its regime: groups
    cost a sort and ``GROUP_SLOTS`` rows a grid list, one slot a list
    reads a crowded list once a pair. A pair's fold depends on the
    pair, r and the fold width alone, so a rescued pair's row is the one
    a grid with room for it gives. ``dropped`` is then int64[2]: the
    pairs still dropped and the pairs rescued.
    """
    C = tile_offsets.shape[0]
    with span("tinyknn.bucket"):
        qgrid, pair_idx, in_slot, dropped = _bucket_pairs(probe_sub, C, qc)
        t_sel = tables_flat[qgrid.clamp(min=0)]       # (C, qc, M)
        if scan_impl != "xla":
            slot_counts = (qgrid >= 0).sum(1, dtype=torch.int32)
        if grid is not None:
            # a round drops at most n - qc pairs, from at most n // (qc + 1)
            # lists; room pairs of m lists fill at most
            # (room + m (q - 1)) / q groups of q
            n, q = probe_sub.numel(), GROUP_SLOTS
            room = max(1, min(grid, n - qc))
            m = min(C, room, n // (qc + 1))
            if 0 < m and 2 * m <= room:   # two or more pairs a list
                over = _overflow_groups(
                    probe_sub, in_slot, dropped, tables_flat, tile_offsets,
                    list_counts, room, -(-(room + m * (q - 1)) // q), q)
            else:
                over = _overflow_grid(probe_sub, in_slot, dropped,
                                      tables_flat, tile_offsets, list_counts,
                                      room)
    with span("tinyknn.scan"):
        if scan_impl == "xla":
            vals, rows = _xla_scan(t_sel, csr_codes, tile_offsets,
                                   list_counts, r, max_tiles)  # (C, qc, r)
            vals = vals.reshape(C * qc, r)[pair_idx]
            rows = rows.reshape(C * qc, r)[pair_idx]
            return (torch.where(in_slot[:, :, None], vals, float("inf")),
                    torch.where(in_slot[:, :, None], rows, 0), dropped)
        kw = dict(fold_tiles=_fold_tiles(r, max_tiles, fold_mult),
                  max_tiles=max_tiles)
        if scan_impl == "fused":
            kw["n_blocks"] = n_blocks
        scan = scan_exact_csr if scan_impl == "exact" else scan_fold_csr
        enc = scan(t_sel, csr_codes, tile_offsets, list_counts,
                   slot_counts=slot_counts, **kw)     # (C, qc, S)
        S = enc.shape[2]
        my_enc = enc.reshape(C * qc, S)[pair_idx]     # (Q, Ps, S)
        my_enc = torch.where(in_slot[:, :, None], my_enc, ENC_INVALID)
        if grid is not None:
            pair, t_over, toff, counts, filled, dropped = over
            enc = scan(t_over, csr_codes, toff, counts, slot_counts=filled,
                       **kw)                          # (O, slots, S)
            # a rescued pair's row holds the sentinel, so the minimum is
            # its fold row; an empty slot's row is all sentinels
            my_enc.view(-1, S).scatter_reduce_(
                0, pair.reshape(-1, 1).expand(-1, S), enc.view(-1, S),
                "amin")
        rowbase = (tile_offsets.long() * LANE_TILE)[
            probe_sub.clamp(max=C - 1)]
    return my_enc, rowbase, dropped


def _overflow_grid(probe_sub, in_slot, dropped, tables_flat, tile_offsets,
                   list_counts, O: int):
    """The overflow grid of a scan round: its first ``O`` dropped pairs
    in pair order as ``O`` lists of one query slot each, compacted on
    the device with no host sync (a cumsum rank and a scatter).

    Returns ``(pair int64[O] each entry's flat (query, probe) index,
    tables [O, 1, M], tile_offsets int32[O], counts int32[O], slot
    counts int32[O], drops int64[2])``: an empty entry points at pair 0
    with no occupied slot, so the kernel scans nothing for it; drops is
    (pairs still dropped, pairs rescued), of the round's ``dropped``."""
    C = tile_offsets.shape[0]
    Ps = probe_sub.shape[1]
    lists = probe_sub.reshape(-1)
    over = ~in_slot.reshape(-1) & (lists < C)
    rank = torch.cumsum(over, 0)                      # 1-based among drops
    # entry 0 takes every other pair and entry O + 1 the drops past O
    dest = (rank * over).clamp(max=O + 1)
    pair = torch.zeros(O + 2, dtype=torch.int64, device=lists.device)
    pair = pair.scatter_(0, dest, torch.arange(
        lists.shape[0], device=lists.device))[1:O + 1]
    filled = (rank[-1] >= torch.arange(1, O + 1, device=lists.device))
    c = lists[pair].clamp(max=C - 1)
    left = (dropped - O).clamp(min=0)
    return (pair, tables_flat[pair // Ps][:, None], tile_offsets[c],
            list_counts[c], filled.to(torch.int32),
            torch.stack([left, dropped - left]))


def _overflow_groups(probe_sub, in_slot, dropped, tables_flat, tile_offsets,
                     list_counts, room: int, O: int, q: int = GROUP_SLOTS):
    """The overflow grid of a scan round whose drops crowd into a few
    lists: its first ``room`` pairs that found their bucket full, list by
    list and in pair order within a list, each list's in groups of ``q``
    as ``O`` grid lists of ``q`` query slots (a list's last group filled
    from its first slot), so that the kernel reads a list once for up to
    ``q`` of its pairs. Compacted on the device with no host sync (a sort
    by list, ranks in runs, scatters); groups past ``O`` stay dropped.

    Returns what ``_overflow_grid`` returns, with ``pair`` int64[O, q]
    and tables [O, q, M]: an empty slot lies past its grid list's slot
    count, so the kernel scans nothing for it, and repeats the grid
    list's first pair (an empty grid list's: the pair of its own index),
    whose list the grid list is, so that a scan of it would hand back
    that pair's own fold row."""
    C = tile_offsets.shape[0]
    Ps = probe_sub.shape[1]
    dev = probe_sub.device
    lists = probe_sub.reshape(-1)
    n = lists.shape[0]
    # every pair but the dropped ones goes to a spare list C, sorted last
    c = torch.where(~in_slot.reshape(-1) & (lists < C), lists, C)
    order = torch.argsort(c, stable=True)
    sc = c[order]
    pos = torch.arange(n, device=dev)
    start = torch.ones_like(sc, dtype=torch.bool)
    start[1:] = sc[1:] != sc[:-1]
    slot = (pos - torch.cummax(torch.where(start, pos, 0), dim=0).values) % q
    entry = torch.cumsum(slot == 0, 0) - 1            # each pair's group
    keep = (sc < C) & (pos < room) & (entry < O)
    entry = torch.where(keep, entry, O)               # O: a spare entry
    pair = (torch.arange(O * q + 1, device=dev) // q % n).scatter_(
        0, torch.where(keep, entry * q + slot, O * q), order)[:O * q]
    filled = torch.zeros(O + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, entry, keep.to(torch.int32))[:O]
    pair = pair.view(O, q)
    pair = torch.where(torch.arange(q, device=dev) < filled[:, None], pair,
                       pair[:, :1])
    of = lists[pair[:, 0]].clamp(max=C - 1)
    rescued = keep.sum()
    return (pair, tables_flat[pair // Ps], tile_offsets[of], list_counts[of],
            filled, torch.stack([dropped - rescued, rescued]))


def _xla_scan(t_sel, csr_codes, tile_offsets, list_counts, r: int,
              max_tiles: int):
    """The 'xla' engine's list scan in plain torch (no kernel).

    t_sel: [C, qc, 16B] block-major tables (value v of block b at
    column 16b + v), int8, bf16 or f32. Each list's ``max_tiles`` tiles
    are densified and its codes one-hot encoded in f32; one batched
    product per step of lists gives every (slot, point) estimate (exact
    for int8 tables: every partial sum is an integer below 2^24), and
    the r smallest per slot, ties to the lower position, are kept.
    Returns ``(vals f32[C, qc, r], rows int64[C, qc, r])``."""
    C, qc, M = t_sel.shape
    B = M // 16
    dev = t_sel.device
    cap = max_tiles * LANE_TILE
    n_rows = csr_codes.shape[0] * LANE_TILE
    step = max(1, XLA_CHUNK_BYTES // (cap * M * 4))
    pos = torch.arange(cap, device=dev)
    block_base = 16 * torch.arange(B, device=dev)
    vals, rows = [], []
    for c0 in range(0, C, step):
        toff = tile_offsets[c0:c0 + step]
        n = toff.shape[0]
        codes = unpack_codes(_tiles_to_dense(csr_codes, toff,
                                             max_tiles))[..., :B]
        onehot = torch.zeros((n, cap, M), dtype=torch.float32, device=dev)
        onehot.scatter_(2, codes.long() + block_base, 1.0)
        est = torch.bmm(t_sel[c0:c0 + step].float(),
                        onehot.transpose(1, 2))      # (n, qc, cap)
        in_list = pos < list_counts[c0:c0 + step, None]
        est = torch.where(in_list[:, None, :], est, float("inf"))
        v, idx = smallest_k(est, r)
        vals.append(v)
        rows.append(((toff.long() * LANE_TILE)[:, None, None] + idx).clamp(
            max=n_rows - 1))
    return torch.cat(vals), torch.cat(rows)


def _select_pool_enc(pools, bases, p1: int, col_bits: int, csr_ids,
                     decode_ids: bool = True):
    """Global candidate selection in the encoded int32 domain.

    pools: per-round encoded fold buffers [(Q, Ps_i, S_i) int32];
    bases: matching flat-row bases [(Q, Ps_i)]. Keeps the p1 smallest
    encodings per query (the encoding is monotone in the estimate, and
    its position bits break ties) and decodes only those. Returns
    ``(cand ids int32[Q, p1] (-1 = invalid), rows int64[Q, p1],
    enc_sel int32[Q, p1])``; with ``decode_ids=False`` (rescore_rows)
    cand is None and the caller decodes ids for the winners only.
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
    if not decode_ids:
        return None, rows, enc_sel
    return torch.where(valid, csr_ids[rows], -1), rows, enc_sel


def _ivf_query(q, pq, active_centers, csr_codes, csr_ids, tile_offsets,
               list_counts, data, csr_raw=None, *, metric: str, k: int,
               n_probes: int, pass_1: int, r: int, r_tail: int, qc: int,
               qc0: int, max_tiles: int, build_probes: int, fold_mult: int,
               scan_impl: str = "fused", grid: int | None = None):
    """The batched bucket-mode IVF query: returns (ids (Q, k), dropped
    pairs); with ``grid`` ('fused' and 'exact'), each scan round scans
    up to ``grid`` of the pairs that overflow its buckets in an overflow
    grid (see ``_bucket_scan_round``), and the drops are int64[2]: the
    pairs still dropped and the pairs rescued.

    ``scan_impl``: 'fused' (K1 over the codes), 'exact' (csr_codes
    holds the exact engine's vector tiles, stage 1 augments the queries
    in place of building tables, and the scan runs K2) or 'xla' (the
    plain torch scan, ``_xla_scan``). ``csr_raw``: the rescore_rows
    copy, read by 'fused' and 'exact'.

    Stages: (1) distance tables; (2) the P nearest lists by exact fp32
    distance to the active centers; (3) bucketed list scans in two
    rounds, each query's nearest list with per-pair depth r and the
    other probes with r_tail; (4) selection of the f * pass_1 smallest
    candidates, f = min(build_probes, n_probes) (a spilled point appears
    in up to f probed lists); (5) exact fp32 rescore, dedup when f > 1,
    top-k.
    """
    Q, d = q.shape
    P = n_probes
    with span("tinyknn.tables"):
        q = _normalize(q, metric)
        tables_flat, B = _scan_tables(q, pq.center_blocks, pq.R,
                                      pq.dims_per_block, pq.table_dtype,
                                      scan_impl)

    # -- probe selection, exact fp32
    with span("tinyknn.probes"):
        probe_sel = _probe_select(q, active_centers, P)   # (Q, P)

    # -- scan rounds
    kw = dict(max_tiles=max_tiles, fold_mult=fold_mult, scan_impl=scan_impl,
              n_blocks=B, grid=grid)
    v0, rows0, dropped = _bucket_scan_round(
        probe_sel[:, :1], tables_flat, csr_codes, tile_offsets, list_counts,
        qc=qc0, r=r, **kw)
    pools, bases = [v0], [rows0]
    if P > 1:
        v1, rows1, drop1 = _bucket_scan_round(
            probe_sel[:, 1:], tables_flat, csr_codes, tile_offsets,
            list_counts, qc=qc, r=r_tail, **kw)
        pools.append(v1)
        bases.append(rows1)
        dropped = dropped + drop1

    # -- selection
    f = min(build_probes, n_probes)
    if scan_impl == "xla":
        with span("tinyknn.pool"):
            flat_vals = torch.cat([v.reshape(Q, -1) for v in pools], dim=1)
            flat_rows = torch.cat([v.reshape(Q, -1) for v in bases], dim=1)
            p1 = min(f * pass_1, flat_vals.shape[1])
            vsel, top_pos = smallest_k(flat_vals, p1)
            rows_sel = torch.gather(flat_rows, 1, top_pos)
            cand = torch.where(torch.isfinite(vsel), csr_ids[rows_sel], -1)
        with span("tinyknn.rescore"):
            return _rescore_topk(cand, data, q, k, f, p1), dropped
    width = sum(p.shape[1] * p.shape[2] for p in pools)
    p1 = min(f * pass_1, width)
    col_bits = 16 if scan_impl == "exact" else fold_encoding(
        tables_flat.dtype, tables_flat.shape[1] // 16, max_tiles)[0]
    with span("tinyknn.pool"):
        cand, rows_sel, enc_sel = _select_pool_enc(
            pools, bases, p1, col_bits, csr_ids, decode_ids=csr_raw is None)
    with span("tinyknn.rescore"):
        if csr_raw is None:
            return _rescore_topk(cand, data, q, k, f, p1), dropped

        # -- rescore_rows: rescore by flat row, decode ids for winners
        diff = csr_raw[rows_sel] - q[:, None, :]      # (Q, p1, d)
        d2 = torch.einsum("qrd,qrd->qr", diff, diff)
        d2 = torch.where(enc_sel < ENC_INVALID, d2, float("inf"))
        return _final_topk(
            d2, lambda pos: csr_ids[torch.gather(rows_sel, 1, pos)], k, f,
            p1)[0], dropped


def _scan_tables(q, center_blocks, R, dpb: int, table_dtype: str,
                 scan_impl: str):
    """Stage 1 for the normalized queries (Q, d): ``(tables_flat, real
    table blocks)`` as ``_bucket_scan_round`` takes them. 'exact': the
    augmented bf16 queries (no blocks: None); 'xla': block-major tables
    (Q, 16 B); 'fused': the same in K1's layout, f32 tables rounded to
    bf16 (the float fold encodes bf16 value bits)."""
    if scan_impl == "exact":
        return _augment_queries(q), None
    tables = _build_tables(q, center_blocks, R, dpb, True, table_dtype).tables
    B = tables.shape[1]
    tables_flat = tables.reshape(q.shape[0], B * 16)
    if scan_impl == "fused":
        tables_flat = permute_tables_csr(tables_flat, B)
        if tables_flat.dtype == torch.float32:
            tables_flat = tables_flat.to(torch.bfloat16)
    return tables_flat, B


def _rescore_topk(cand, data, q, k: int, f: int, p1: int):
    """Stage 5: exact fp32 squared distances of the candidate ids
    (Q, p1) (-1 = invalid), then ``_final_topk``."""
    diff = data[cand.clamp(min=0).long()] - q[:, None, :]  # (Q, p1, d)
    d2 = torch.einsum("qrd,qrd->qr", diff, diff)
    d2 = torch.where(cand >= 0, d2, float("inf"))
    return _final_topk(d2, lambda pos: torch.gather(cand, 1, pos), k, f,
                       p1)[0]


def _final_topk(d2, ids_at, k: int, f: int, p1: int):
    """The top k of rescored candidates (Q, p1) as ``(ids, d2)``, ids -1
    (and d2 +inf) where none is valid. ``ids_at(pos)`` gives the ids of candidate positions; it is called
    on the k * f sliver when f > 1 (build-spill duplicates are removed
    there) and on the k winners otherwise, so ids decode late."""
    if f > 1:
        _, best = smallest_k(d2, min(k * f, p1))
        d2 = torch.gather(d2, 1, best)
        cand = torch.where(torch.isfinite(d2), ids_at(best), -1)
        cand, d2 = dedup_candidates(cand, d2)
        out_d2, best = smallest_k(d2, k)
        out = torch.gather(cand, 1, best)
    else:
        out_d2, best = smallest_k(d2, k)
        out = ids_at(best)
    return torch.where(torch.isfinite(out_d2), out, -1), out_d2


# --------------------------------------------------------- gather mode


def _ivf_query_gather(q, pq, active_centers, csr_codes, csr_ids,
                      tile_offsets, list_counts, data, *, metric: str,
                      k: int, n_probes: int, pass_1: int, max_tiles: int,
                      exact: bool = False):
    """Latency-mode query: each query gathers its probed lists.

    Every probed list is densified to ``max_tiles`` tiles, and each
    query sums its own tables over their codes (``_gather_estimates``);
    ``exact``: csr_codes holds the exact engine's vector tiles, and one
    dot product with the augmented query gives the bf16-rounded
    distance. The whole (Q, P * cap) pool is deduplicated, cut to
    pass_1, rescored in fp32 and cut to k. No bucketing, so nothing is
    dropped, and no kernel: at Q * P <= 64 the work is small.
    """
    Q, _ = q.shape
    cap = max_tiles * LANE_TILE
    q = _normalize(q, metric)
    probe_sel = _probe_select(q, active_centers, n_probes)  # (Q, P)
    toff_p = tile_offsets[probe_sel]
    rows_p = _rows_of(toff_p, cap, csr_ids.shape[0])  # (Q, P, cap)
    in_list = (torch.arange(cap, device=q.device)
               < list_counts[probe_sel][:, :, None])
    ids_p = torch.where(in_list, csr_ids[rows_p], -1)
    dense = _tiles_to_dense(csr_codes, toff_p, max_tiles)
    if exact:
        qa = _augment_queries(q).float()
        est = torch.einsum("qpcd,qd->qpc", dense.float(), qa)
    else:
        tables = _build_tables(q, pq.center_blocks, pq.R, pq.dims_per_block,
                               True, pq.table_dtype).tables
        est = _gather_estimates(tables, unpack_codes(dense))
    est = torch.where(ids_p >= 0, est, float("inf"))
    flat_ids, flat_vals = dedup_candidates(ids_p.reshape(Q, -1),
                                           est.reshape(Q, -1))
    p1 = min(pass_1, flat_vals.shape[1])
    _, top_pos = smallest_k(flat_vals, p1)
    return _rescore_topk(torch.gather(flat_ids, 1, top_pos), data, q, k, 1,
                         p1)


def _gather_estimates(tables, codes):
    """PQ estimates of each query over its own gathered codes.

    tables: [Q, B, 16] int8, bf16 or f32; codes: uint8[Q, P, cap, >= B]
    (storage pad blocks past B are ignored). Gathers each table entry
    by code (no one-hot) and sums over the blocks: in int32 for int8
    tables (exact), in f32 in block order for float ones. Returns
    f32[Q, P, cap]."""
    Q, B, _ = tables.shape
    shape = codes.shape[:-1]
    idx = (codes[..., :B].long()
           + 16 * torch.arange(B, device=codes.device)).reshape(Q, -1)
    vals = torch.gather(tables.reshape(Q, B * 16), 1, idx).reshape(
        shape + (B,))
    if tables.dtype == torch.int8:
        return vals.to(torch.int32).sum(-1).to(torch.float32)
    vals = vals.to(torch.float32)
    est = vals[..., 0].clone()
    for b in range(1, B):
        est += vals[..., b]
    return est


# -------------------------------------------------------------- tuning


class TuneResult(NamedTuple):
    """Result of ``tune_n_probes``."""
    n_probes: int
    pass_1: int
    recall: float
    recalls: dict   # {(n_probes, pass_1): measured recall}


def tune_n_probes(ivf, queries, true_neighbours, k=10, target_recall=0.9,
                  max_probes=None, pass1_mults=(2.0, 4.0, 8.0),
                  verbose=False):
    """Cheapest (n_probes, pass_1) reaching ``target_recall`` on a
    validation set, searched as the JAX package searches it.

    n_probes grows (by about its square root each step) until the
    widest pass-1 pool reaches the target; within that n_probes the
    pool multipliers ``pass1_mults`` (multiples of (P + 1) k + 1) are
    tried from the narrowest up and the first that reaches the target
    wins. On an exact-engine index pass_1 is the rescore sliver, so the
    pools are ``mult * k * n_probes``. If no n_probes reaches the
    target, the best measured point is returned. Returns
    ``TuneResult(n_probes, pass_1, recall, recalls)``.
    """
    queries = as_f32(queries, ivf.device)
    if isinstance(true_neighbours, torch.Tensor):
        true_neighbours = true_neighbours.cpu().numpy()
    trus = [set(np.asarray(t).tolist()) for t in true_neighbours]
    max_probes = max_probes or ivf.active_centers.shape[0]
    mults = sorted(pass1_mults)
    recalls = {}
    exact = ivf.scan_impl == "exact"

    def measure(n_probes, mult):
        if exact:  # pass_1 = rescore-sliver width (default 4*k*P)
            p1 = max(int(mult * k * max(n_probes, 1)), k)
        else:
            p1 = int(mult * ((n_probes + 1) * k + 1))
        if (n_probes, p1) in recalls:
            return p1, recalls[(n_probes, p1)]
        guesses = ivf.query(queries, k=k, n_probes=n_probes,
                            pass_1=p1).cpu().numpy()
        recall = float(np.mean(
            [len(trus[i] & set(g.tolist())) / max(len(trus[i]), 1)
             for i, g in enumerate(guesses)]))
        recalls[(n_probes, p1)] = recall
        if verbose:
            print(f"tune: n_probes={n_probes} pass_1={p1} "
                  f"recall={recall:.4f}")
        return p1, recall

    n_probes = 1
    while n_probes <= max_probes:
        p1, recall = measure(n_probes, mults[-1])
        if recall >= target_recall:
            for mult in mults[:-1]:
                p1_lo, recall_lo = measure(n_probes, mult)
                if recall_lo >= target_recall:
                    return TuneResult(n_probes, p1_lo, recall_lo, recalls)
            return TuneResult(n_probes, p1, recall, recalls)
        n_probes += max(int(n_probes ** 0.5), 1)
    best = max(recalls, key=recalls.get)
    return TuneResult(best[0], best[1], recalls[best], recalls)
