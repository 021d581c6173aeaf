"""List-sharded IVF over a device mesh (counterpart of
tinyknn_tpu/parallel/sharded_ivf.py).

  * the CSR tile arrays (codes (T, B/2, 128), flat ids (T * 128,) and
    flat raw vectors (T * 128, d) for the rescore) are split into
    contiguous per-shard list ranges, each padded to the largest
    shard's tile count, and placed over the mesh on the list axis; the
    PQ codebooks, the coarse centers and the query batch are replicated
    (KB-scale);
  * each shard runs the single-device index's bucketed scan rounds, but
    only over the probed lists it owns; the tables and the probe
    selection are computed again on every device (once for all the
    shards it holds), so nothing is exchanged until the end;
  * the rescore is local too (each shard holds its lists' raw vectors),
    so the only exchange is a gather of the per-shard (Q, k) results to
    one device and a merge there: k * n_shards * 8 bytes per query;
  * a second mesh axis can split the query batch (pure data
    parallelism); the gather runs along the list axis only.

One process drives the whole mesh: ``_shard_local_query`` is a plain
function of one shard's tensors and its index, called once per mesh
position on that position's device, and the gather is a device-to-device
copy of each shard's result. A mesh may hold one device at several
positions: those shards then run in turn on it.

Also here: ``lloyd_step_dp``, a data-parallel k-means step (local
accumulation, then a sum over the shards).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.fast_pq import as_f32
from ..models.ivf import (
    ENC_INVALID,
    IVF,
    LANE_TILE,
    _augment_data_csr,
    _bucket_scan_round,
    _check_scan_impl,
    _csr_raw_rows,
    _final_topk,
    _normalize,
    _probe_select,
    _query_params,
    _query_stats,
    _query_with_retries,
    _scan_tables,
    _select_pool_enc,
)
from ..ops.kernels import fold_encoding
from ..ops.kmeans import _pairwise_sq
from ..ops.topk import dedup_candidates, smallest_k
from ..utils.bruteforce import fp32_matmuls
from ..utils.padding import round_up
from .mesh import make_mesh, place, replicate, shard_on_axis0

PAD_CENTER = 1e9  # coordinate of the centers that pad the list count


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for a shard's work (kernels
    launch on the current device's stream); nothing to do on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedIVF(IVF):
    """IVF with its inverted lists sharded over a device mesh.

    fit/build run like the base class on ``device`` (default: the
    quantizer's, or the mesh's first device), then the lists are placed over the mesh; ``query``
    and ``query_stream`` run every shard and merge. Answers come back on
    ``device``. There is no gather mode; ``rescore_rows`` is inherent
    (each shard rescores by flat row from its own raw vectors and
    decodes ids late), so the flag allocates nothing.
    """

    _sharded = True

    def __init__(self, metric, n_clusters, pq=None, mesh=None, axis="shards",
                 query_axis=None, device=None, **kw):
        """``mesh``: a ``parallel.Mesh`` (default: ``make_mesh(axis=axis)``,
        the visible CUDA devices). ``axis`` names the mesh axis that
        shards the inverted lists. ``query_axis`` (2-D mesh, see
        ``make_mesh_2d``) also splits the query batch: pure data
        parallelism on top of the list sharding."""
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.query_axis = query_axis
        self._grid = self.mesh.grid(axis, query_axis)
        if device is None:  # the quantizer's, else the mesh's first
            device = (pq.device if pq is not None
                      else self.mesh.devices[self._grid[0][0]])
        super().__init__(metric, n_clusters, pq, device=device, **kw)
        self.list_vecs = None

    def build(self, X, n_probes=2, labels=None, verbose=False):
        super().build(X, n_probes, labels=labels, verbose=verbose)
        self._place()
        return self

    def _place(self):
        """Split the CSR tile arrays into contiguous per-shard list
        ranges (each padded with the guard tile to the largest shard's
        tile count), derive each shard's flat raw-vector array for the
        local rescore, and place everything over the list axis. Only the
        small offset and count vectors pass through the host."""
        n_dev = self.mesh.shape[self.axis]
        toff = self.tile_offsets.cpu().numpy()
        counts = self.list_counts.cpu().numpy()
        C = toff.shape[0]
        C_pad = round_up(C, n_dev)
        Cl = C_pad // n_dev
        ntiles = -(-counts.astype(np.int64) // LANE_TILE)
        ends = toff.astype(np.int64) + ntiles          # end tile per list
        # a pad list holds nothing and is never probed: offset 0, count 0
        toff_p = np.concatenate([toff, np.zeros(C_pad - C, np.int32)])
        counts_p = np.concatenate([counts, np.zeros(C_pad - C, np.int32)])
        # shard s owns lists [s * Cl, (s + 1) * Cl): tiles [start, stop)
        owns = [s * Cl < C for s in range(n_dev)]
        starts = np.array([toff_p[s * Cl] if owns[s] else 0
                           for s in range(n_dev)], np.int64)
        stops = np.array([ends[min((s + 1) * Cl, C) - 1] if owns[s] else 0
                          for s in range(n_dev)], np.int64)
        T_l = int(max(1, (stops - starts).max())) + 1  # + 1 guard tile
        guard = self.csr_codes.shape[0] - 1            # global guard tile
        exact = self.scan_impl == "exact"
        if exact:
            self._check_exact_fits()

        ids_tiles = self.csr_ids.reshape(-1, LANE_TILE)
        codes, ids, toffs, cnts, vecs, aug = [], [], [], [], [], []
        for s in range(n_dev):
            idx = torch.as_tensor(np.concatenate([
                np.arange(starts[s], stops[s]),
                np.full(T_l - int(stops[s] - starts[s]), guard, np.int64)]),
                device=self.device)
            codes.append(self.csr_codes[idx])
            ids.append(ids_tiles[idx].reshape(-1))
            real = np.arange(s * Cl, (s + 1) * Cl) < C
            local = toff_p[s * Cl:(s + 1) * Cl] - starts[s]
            toffs.append(torch.as_tensor(
                np.where(real, local, 0).astype(np.int32)))
            cnts.append(torch.as_tensor(counts_p[s * Cl:(s + 1) * Cl]))
            vecs.append(_csr_raw_rows(self.data, ids[-1]))
            if exact:
                aug.append(_augment_data_csr(self.data, ids[-1]))
        centers = torch.nn.functional.pad(
            self.active_centers, (0, 0, 0, C_pad - C), value=PAD_CENTER)

        def put(shards):
            return place(self.mesh, shards, self.axis)

        self.csr_codes, self.csr_ids = put(codes), put(ids)
        self.tile_offsets, self.list_counts = put(toffs), put(cnts)
        self.list_vecs = put(vecs)
        self.csr_vecs = put(aug) if exact else None
        self.csr_raw = None
        # the padded centers, on ``device`` for the capacity helpers and
        # replicated for the shards
        self.active_centers = centers
        self._centers = replicate(self.mesh, centers)
        self._pq_blocks = replicate(self.mesh, self.pq.center_blocks)
        self._pq_R = (None if self.pq.R is None
                      else replicate(self.mesh, self.pq.R))
        self._n_active_real = C
        self._shard_tiles = T_l
        self._shard_meta = (starts, stops, Cl, C)      # for save_ivf

    def set_scan_impl(self, scan_impl):
        """Switch the list-scan engine of a placed index. The exact
        engine's vector tiles are derived from each shard's own flat ids
        and placed like the lists."""
        _check_scan_impl(scan_impl)
        if scan_impl != "exact":
            self.csr_vecs = None
        elif self.csr_vecs is None and self.list_vecs is not None:
            self._check_exact_fits()
            self.csr_vecs = place(
                self.mesh,
                [_augment_data_csr(self.data, ids.to(self.device))
                 for ids in self.csr_ids.shards()], self.axis)
        self.scan_impl = scan_impl
        return self

    def set_rescore_rows(self, enabled=True):
        """Keeps the flag and allocates nothing: the sharded rescore
        always reads raw rows from the per-shard ``list_vecs`` and
        decodes ids late."""
        self.rescore_rows = bool(enabled)
        self.csr_raw = None
        return self

    # ------------------------------------------------------------- query

    def query(self, q, k, n_probes=1, pass_1=None, with_stats=False):
        """Top-k ids for one query (d,) or a (Q, d) batch, as
        ``IVF.query`` in bucket mode: int32 (int64 with labels) on
        ``device``, -1 where no candidate was found. Dropped pairs are
        summed over the mesh and drive the same capacity retries."""
        self._check_built()
        fp32_matmuls()
        q = as_f32(q, self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        q_dev = len(self._grid)
        true_q = q.shape[0]
        if true_q % q_dev:  # the query rows take equal slices
            q = torch.nn.functional.pad(
                q, (0, 0, 0, q_dev - true_q % q_dev))
        # capacities are per (query row, shard): each position buckets
        # its q_local queries over its own lists; probes clamp to the
        # global list count (selection is global)
        q_local, view = self._batch_view(q.shape[0])
        params = _query_params(self, q_local, k, n_probes, pass_1, **view)
        k, n_probes, pass_1, r, r_tail, _, _ = params
        out, dropped, qc, qc0 = _query_with_retries(self, q, params, q_local,
                                                    **view)
        out = out[:true_q].to(self.device)
        out = self._map_labels(out[0] if single else out)
        if with_stats:
            return out, _query_stats(dropped, true_q * n_probes, qc, qc0,
                                     pass_1, per_pair_candidates=(r, r_tail))
        return out

    # ``query_stream`` is the base class's over the three hooks below:
    # the batches run one after another over the mesh, tables are built
    # per batch on each shard, and the host waits once, for the ids and
    # the pairs dropped over the whole stream and mesh. ``device_out=True``
    # returns them on the mesh's first device. The stream's peak per-list
    # load is measured globally (selection is the same on every shard, so
    # the global peak bounds each shard's load) and clamped by the
    # per-shard scan-grid budget.

    def _batch_view(self, Q: int):
        """A mesh position's view of a batch of Q: its query row's slice
        over the lists of one shard; probes clamp to the real list
        count."""
        q_dev = len(self._grid)
        if Q % q_dev:
            raise ValueError(f"a stream batch of {Q} queries does not "
                             f"divide over {q_dev} query rows")
        return Q // q_dev, dict(n_active=max(self._shard_meta[2], 1),
                                n_probes_max=self._n_active_real)

    def _answer_device(self):
        return self.mesh.devices[self._grid[0][0]]

    def _bucket_query(self, q, params, scan_impl, grid=None):
        # the mesh rounds scan no overflow grid: ShardedIVF.query never
        # asks for one, and retries its drops as the JAX package does
        return self._mesh_query(q, params, scan_impl)

    def _mesh_query(self, q, params, scan_impl):
        """One batch over the mesh: ``(ids int32 (Q, k), dropped pairs)``
        on the mesh's first device, with no host synchronisation. Each
        query row takes its slice of ``q`` and runs every shard of its
        row; the shards' (Q, k) results are copied to the row's first
        device in shard order and merged there."""
        k, n_probes, pass_1, r, r_tail, qc, qc0 = params
        devices = self.mesh.devices
        first = devices[self._grid[0][0]]
        codes = self.csr_vecs if scan_impl == "exact" else self.csr_codes
        outs, dropped = [], 0
        for row, q_row in zip(self._grid, q.chunk(len(self._grid))):
            home = devices[row[0]]
            prepared, ids, d2 = {}, [], []
            for me, pos in enumerate(row):
                dev = devices[pos]
                replicated = (
                    self._centers[pos], self._pq_blocks[pos],
                    None if self._pq_R is None else self._pq_R[pos])
                common = dict(dpb=self.pq.dims_per_block,
                              table_dtype=self.pq.table_dtype,
                              metric=self.metric, n_probes=n_probes,
                              scan_impl=scan_impl)
                with on_device(dev):
                    if dev not in prepared:  # once per (device, query row)
                        prepared[dev] = _shard_prepare(
                            q_row.to(dev, non_blocking=True), *replicated,
                            **common)
                    ids_s, d2_s, drop = _shard_local_query(
                        None, *replicated, codes[pos], self.csr_ids[pos],
                        self.tile_offsets[pos], self.list_counts[pos],
                        self.list_vecs[pos], me=me, k=k, pass_1=pass_1, r=r,
                        r_tail=r_tail, qc=qc, qc0=qc0,
                        max_tiles=self.max_tiles,
                        build_probes=self.build_probes,
                        fold_mult=self.fold_mult, prepared=prepared[dev],
                        **common)
                ids.append(ids_s.to(home, non_blocking=True))
                d2.append(d2_s.to(home, non_blocking=True))
                dropped = dropped + drop.to(first, non_blocking=True)
            with on_device(home):
                outs.append(merge_shards(ids, d2, k).to(first,
                                                        non_blocking=True))
        return torch.cat(outs), dropped


def _shard_prepare(q, centers, pq_blocks, pq_R, *, dpb: int,
                   table_dtype: str, metric: str, n_probes: int,
                   scan_impl: str):
    """The part of a shard's work that no shard's lists enter: the
    normalised queries, their scan tables and the global probe
    selection, ``(q, tables_flat, B, probe_sel)``. Every shard computes
    the same from its replicated copies, so a mesh that holds a device
    at several positions computes it once per (device, query row)."""
    q = _normalize(q, metric)
    tables_flat, B = _scan_tables(q, pq_blocks, pq_R, dpb, table_dtype,
                                  scan_impl)
    return q, tables_flat, B, _probe_select(q, centers, n_probes)


def _shard_local_query(q, centers, pq_blocks, pq_R, codes_l, ids_l, toff_l,
                       counts_l, vecs_l, *, me: int, dpb: int,
                       table_dtype: str, metric: str, k: int, n_probes: int,
                       pass_1: int, r: int, r_tail: int, qc: int, qc0: int,
                       scan_impl: str, max_tiles: int, build_probes: int,
                       fold_mult: int, prepared=None):
    """One shard's share of a batch: the single-device index's two
    bucketed scan rounds over the lists this shard owns, then the local
    rescore. Returns ``(ids int32 (Q, k), d2 f32 (Q, k), dropped
    pairs)`` on the shard's device, ids -1 and d2 +inf where the shard
    found no candidate.

    q: (Q, d) raw queries; centers: (C_pad, d) all shards' centers, the
    pad ones far away; pq_blocks, pq_R: the PQ codebooks; codes_l (the
    exact engine: the vector tiles), ids_l, toff_l, counts_l: the
    shard's CSR arrays with local tile offsets; vecs_l: its flat raw
    vectors; ``me``: the shard's index, which owns the global lists
    [me * Cl, (me + 1) * Cl). Everything else is ``_ivf_query``'s.
    ``prepared``: ``_shard_prepare``'s result for these queries on this
    device, where a caller already has it (``q`` is then not read).
    """
    if prepared is None:
        prepared = _shard_prepare(
            q, centers, pq_blocks, pq_R, dpb=dpb, table_dtype=table_dtype,
            metric=metric, n_probes=n_probes, scan_impl=scan_impl)
    # -- normalised queries, tables, global probe selection (Q, P)
    q, tables_flat, B, probe_sel = prepared
    Q = q.shape[0]
    Cl = toff_l.shape[0]

    # -- local list index; a pair another shard owns goes to the
    # sentinel id Cl, which the scan round gives no slot, and its rows
    # are masked below
    local_c = probe_sel - me * Cl
    is_local = (local_c >= 0) & (local_c < Cl)
    probes_local = torch.where(is_local, local_c, Cl)

    kw = dict(max_tiles=max_tiles, fold_mult=fold_mult, scan_impl=scan_impl,
              n_blocks=B)
    rounds = [(probes_local[:, :1], is_local[:, :1], qc0, r)]
    if n_probes > 1:
        rounds.append((probes_local[:, 1:], is_local[:, 1:], qc, r_tail))
    pools, bases, dropped = [], [], 0
    for probe_sub, ok, cap, depth in rounds:
        v, rows, drop = _bucket_scan_round(
            probe_sub, tables_flat, codes_l, toff_l, counts_l, qc=cap,
            r=depth, **kw)
        if scan_impl == "xla":
            v = torch.where(ok[:, :, None], v, float("inf"))
            rows = torch.where(ok[:, :, None], rows, 0)
        else:
            v = torch.where(ok[:, :, None], v, ENC_INVALID)
        pools.append(v)
        bases.append(rows)
        dropped = dropped + drop

    # -- selection: f * pass_1 slots, so that pass_1 distinct candidates
    # reach the rescore (see _ivf_query)
    f = min(build_probes, n_probes)
    if scan_impl == "xla":
        flat_vals = torch.cat([v.reshape(Q, -1) for v in pools], dim=1)
        flat_rows = torch.cat([v.reshape(Q, -1) for v in bases], dim=1)
        p1 = min(f * pass_1, flat_vals.shape[1])
        vsel, top_pos = smallest_k(flat_vals, p1)
        rows_sel = torch.gather(flat_rows, 1, top_pos)
        valid = torch.isfinite(vsel)
    else:
        width = sum(p.shape[1] * p.shape[2] for p in pools)
        p1 = min(f * pass_1, width)
        col_bits = 16 if scan_impl == "exact" else fold_encoding(
            tables_flat.dtype, tables_flat.shape[1] // 16, max_tiles)[0]
        _, rows_sel, enc_sel = _select_pool_enc(
            pools, bases, p1, col_bits, ids_l, decode_ids=False)
        valid = enc_sel < ENC_INVALID

    # -- local exact rescore by flat row; ids decode for the k * f sliver
    # (f > 1) or the k winners only
    rows_sel = rows_sel.clamp(0, vecs_l.shape[0] - 1)
    diff = vecs_l[rows_sel] - q[:, None, :]           # (Q, p1, d)
    d2 = torch.einsum("qrd,qrd->qr", diff, diff)
    d2 = torch.where(valid, d2, float("inf"))
    ids, d2 = _final_topk(
        d2, lambda pos: ids_l[torch.gather(rows_sel, 1, pos)], k, f, p1)
    return ids, d2, dropped


def merge_shards(ids, d2, k: int, dedup: bool = True):
    """Merge per-shard results: ``ids``/``d2`` are lists of (Q, k)
    tensors on one device, in shard order. Columns are joined in that
    order (so equal distances keep the lower shard first), duplicates
    across shards removed (a point placed in several lists can surface
    on two shards) unless ``dedup`` is off, and the k nearest kept; -1
    where fewer than k are valid."""
    all_ids, all_d2 = torch.cat(ids, dim=1), torch.cat(d2, dim=1)
    if dedup:
        all_ids, all_d2 = dedup_candidates(all_ids, all_d2)
    out_d2, best = smallest_k(all_d2, k)
    out = torch.gather(all_ids, 1, best)
    return torch.where(torch.isfinite(out_d2), out, -1)


def lloyd_step_dp(X, centers, mesh, axis: str = "shards"):
    """One data-parallel Lloyd iteration over the mesh.

    ``X`` (n, d) is split on dim 0 over ``axis`` and ``centers`` (k, d)
    replicated; each shard assigns its rows and accumulates per-center
    sums, counts and its inertia, which are then added over the shards
    on the mesh's first device. Returns ``(new centers (k, d), inertia)``
    there; a center with no row keeps its place."""
    fp32_matmuls()
    grid = mesh.grid(axis)[0]
    home = mesh.devices[grid[0]]
    X = as_f32(X, home)
    centers = as_f32(centers, home)
    X_l = shard_on_axis0(mesh, X, axis=axis)
    C_l = replicate(mesh, centers)
    sums = counts = inertia = 0
    for pos in grid:
        with on_device(mesh.devices[pos]):
            s, c, i = _lloyd_local(X_l[pos], C_l[pos])
        sums = sums + s.to(home, non_blocking=True)
        counts = counts + c.to(home, non_blocking=True)
        inertia = inertia + i.to(home, non_blocking=True)
    new = torch.where(counts[:, None] > 0,
                      sums / counts[:, None].clamp(min=1.0), centers)
    return new, inertia


def _lloyd_local(X, C, chunk: int = 16384):
    """A shard's per-center sums (k, d), counts (k,) and inertia,
    accumulated over row chunks (memory stays bounded at any n)."""
    sums = torch.zeros_like(C)
    counts = torch.zeros(C.shape[0], dtype=torch.float32, device=C.device)
    inertia = torch.zeros((), dtype=torch.float32, device=C.device)
    for i in range(0, X.shape[0], chunk):
        Xi = X[i:i + chunk]
        best, assign = _pairwise_sq(Xi, C).min(dim=1)
        sums.index_add_(0, assign, Xi)
        counts.index_add_(0, assign, torch.ones_like(best))
        inertia += best.sum()
    return sums, counts, inertia
