"""Save and load IVF and FastPQ archives (counterpart of tinyknn_tpu/io.py).

An archive is one npz file: the CSR-tiled lists plus the PQ codebooks
and two JSON metadata records (``ivf_meta``, ``pq_meta``). The port
writes the same keys and the same metadata fields as
``tinyknn_tpu.io.save_ivf``/``save_pq`` (format v3), so an index built
by either package serves from the other. It reads v3 and the older
dense-grid v1/v2 archives, which are converted to the CSR layout on
load, and it reads metadata with the JAX loader's defaults for every
field an older writer may have left out.

A placed ``ShardedIVF`` is written as the same archive: the per-shard
tile padding is stripped and the offsets re-based, so the file does not
depend on the mesh and loads onto any other mesh (``load_sharded_ivf``)
or as a single-device index (``load_ivf``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .models.fast_pq import FastPQ
from .models.ivf import IVF
from .ops.kernels import LANE_TILE
from .parallel.sharded_ivf import ShardedIVF
from .utils.padding import round_up

FORMAT_VERSION = 3
_COMMON = frozenset({"format", "kind", "ivf_meta", "all_centers",
                     "active_centers", "data", "pq_center_blocks",
                     "pq_meta"})
_REQUIRED = {  # by format: v3 CSR tiles, v1/v2 dense (C, cap) grids
    3: _COMMON | {"csr_codes", "csr_ids", "tile_offsets", "list_counts"},
    2: _COMMON | {"list_codes", "list_ids"},
    1: _COMMON | {"list_codes", "list_ids"},
}
_OPTIONAL = {3: frozenset({"labels", "pq_R"}),
             2: frozenset({"labels", "pq_R", "list_counts"}),
             1: frozenset({"labels", "pq_R", "list_counts"})}
_PQ_REQUIRED = frozenset({"format", "kind", "pq_center_blocks", "pq_meta"})
# metadata an older writer may lack, with the JAX loader's defaults
_IVF_DEFAULTS = dict(kmeans_iters=30, queries_per_cluster=None,
                     pass1_method="auto", scan_impl="auto", fold_mult=8,
                     rescore_rows=False, scan_budget_bytes=2 << 30)
_PQ_DEFAULTS = dict(kmeans_iters=25, kmeans_n_init=2, table_dtype="int8")


def _meta(state, key) -> dict:
    return json.loads(bytes(np.asarray(state[key])).decode())


def _json_bytes(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _check_keys(state, required, optional, kind: bytes):
    keys = set(state)
    if not required <= keys or keys - required - optional:
        raise ValueError(
            f"not a {kind.decode()} archive: missing "
            f"{sorted(required - keys)}, unknown "
            f"{sorted(keys - required - optional)}")
    if bytes(np.asarray(state["kind"])) != kind:
        raise ValueError(f"not a {kind.decode()} archive")


def _format(state, versions) -> int:
    if "format" not in state:
        raise ValueError("not an archive: no format key")
    version = int(state["format"])
    if version not in versions:
        raise ValueError(f"archive format v{version} is not one of "
                         f"{sorted(versions)}")
    return version


# ------------------------------------------------------------------ write


def _pq_state(pq: FastPQ) -> dict:
    """The ``pq_*`` arrays of a fitted FastPQ, as the JAX package writes
    them."""
    state = {
        "pq_center_blocks": pq.center_blocks.cpu().numpy(),
        "pq_meta": _json_bytes({
            "dims_per_block": pq.dims_per_block,
            "use_kmeans": pq.use_kmeans,
            "rotate_dim": pq.rotate_dim,
            "seed": pq.seed,
            "backend": pq.backend,
            "kmeans_iters": pq.kmeans_iters,
            "kmeans_n_init": pq.kmeans_n_init,
            "table_dtype": pq.table_dtype,
        }),
    }
    if pq.R is not None:
        state["pq_R"] = pq.R.cpu().numpy()
    return state


def save_pq(path, pq: FastPQ, compress: bool = False):
    """Write a fitted FastPQ as a v3 ``kind=fastpq`` archive."""
    if pq.centers is None:
        raise RuntimeError("save_pq: PQ not fitted")
    saver = np.savez_compressed if compress else np.savez
    saver(path, format=np.int32(FORMAT_VERSION),
          kind=np.frombuffer(b"fastpq", np.uint8), **_pq_state(pq))


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _unshard_csr(ivf: ShardedIVF):
    """The global CSR arrays of a placed ShardedIVF (see
    ``ShardedIVF._place``): each shard's tile padding stripped, the
    offsets re-based, the pad lists cut and one guard tile appended."""
    starts, stops, _, C = ivf._shard_meta
    codes, ids, toffs, counts = [], [], [], []
    base = 0
    for s, (codes_s, ids_s, toff_s, counts_s) in enumerate(zip(
            ivf.csr_codes.shards(), ivf.csr_ids.shards(),
            ivf.tile_offsets.shards(), ivf.list_counts.shards())):
        n_t = int(stops[s] - starts[s])
        codes.append(_host(codes_s[:n_t]))
        ids.append(_host(ids_s[:n_t * LANE_TILE]))
        toffs.append(_host(toff_s) + base)
        counts.append(_host(counts_s))
        base += n_t
    codes.append(np.zeros_like(codes[0][:1]))
    ids.append(np.full(LANE_TILE, -1, np.int32))
    return (np.concatenate(codes), np.concatenate(ids),
            np.concatenate(toffs)[:C].astype(np.int32),
            np.concatenate(counts)[:C].astype(np.int32))


def save_ivf(path, ivf: IVF, compress: bool = False):
    """Write a built IVF, or a placed ShardedIVF, as a v3 archive: the
    keys and metadata fields of ``tinyknn_tpu.io.save_ivf``, so
    ``tinyknn_tpu.io.load_ivf`` reads it. Derived state (the exact
    engine's tiles, the rescore_rows copy, a shard's raw vectors) is
    not stored: loaders rebuild it from (data, csr_ids).

    ``compress`` is off by default: codes and float vectors barely
    compress, and deflate is slow at a million points."""
    if ivf.csr_codes is None:
        raise RuntimeError("save_ivf: index not built")
    host = _host
    if isinstance(ivf, ShardedIVF):
        csr_codes, csr_ids, tile_offsets, list_counts = _unshard_csr(ivf)
        active_centers = _host(ivf.active_centers)[:ivf._n_active_real]
    else:
        csr_codes, csr_ids = _host(ivf.csr_codes), _host(ivf.csr_ids)
        tile_offsets = _host(ivf.tile_offsets)
        list_counts = _host(ivf.list_counts)
        active_centers = _host(ivf.active_centers)

    saver = np.savez_compressed if compress else np.savez
    saver(
        path, format=np.int32(FORMAT_VERSION),
        kind=np.frombuffer(b"ivf", np.uint8),
        ivf_meta=_json_bytes({
            "metric": ivf.metric,
            "n_clusters": ivf.n_clusters,
            "seed": ivf.seed,
            "kmeans_iters": ivf.kmeans_iters,
            "queries_per_cluster": ivf.queries_per_cluster,
            "pass1_method": ivf.pass1_method,
            "scan_impl": ivf.scan_impl,
            "build_probes": int(ivf.build_probes),
            "fold_mult": ivf.fold_mult,
            "rescore_rows": bool(ivf.rescore_rows),
            "scan_budget_bytes": int(ivf.scan_budget_bytes),
        }),
        all_centers=_host(ivf.all_centers),
        active_centers=active_centers,
        csr_codes=csr_codes,
        csr_ids=csr_ids,
        tile_offsets=tile_offsets,
        list_counts=list_counts,
        data=_host(ivf.data),
        **({"labels": _host(ivf.labels)} if ivf.labels is not None else {}),
        **_pq_state(ivf.pq))


# ------------------------------------------------------------------- read


def _pq_restore(state, device: torch.device) -> FastPQ:
    """A fitted port FastPQ on ``device`` from the ``pq_*`` arrays."""
    meta = {**_PQ_DEFAULTS, **_meta(state, "pq_meta")}
    pq = FastPQ(dims_per_block=meta["dims_per_block"],
                use_kmeans=meta["use_kmeans"],
                rotate_dim=meta["rotate_dim"], seed=meta["seed"],
                backend=meta["backend"], kmeans_iters=meta["kmeans_iters"],
                kmeans_n_init=meta["kmeans_n_init"],
                table_dtype=meta["table_dtype"], device=device)
    pq.center_blocks = torch.as_tensor(np.asarray(state["pq_center_blocks"]),
                                       dtype=torch.float32, device=device)
    B, _, dpb = pq.center_blocks.shape
    pq.centers = pq.center_blocks.transpose(0, 1).reshape(16, B * dpb)
    pq.sqrt_n_blocks = float(np.sqrt(B))
    if "pq_R" in state:
        pq.R = torch.as_tensor(np.asarray(state["pq_R"]),
                               dtype=torch.float32, device=device)
    return pq


def pq_from_state(state: dict[str, np.ndarray], device) -> FastPQ:
    """A fitted port ``FastPQ`` on ``device`` from the arrays of a v3
    ``kind=fastpq`` archive (the keys ``save_pq`` writes, optional
    ``pq_R`` included). Its ``backend`` is kept and routes nothing."""
    _check_keys(state, _PQ_REQUIRED, frozenset({"pq_R"}), b"fastpq")
    _format(state, (FORMAT_VERSION,))
    return _pq_restore(state, torch.device(device))


def load_pq(path, device) -> FastPQ:
    """``np.load`` of a v3 FastPQ archive + ``pq_from_state``."""
    with np.load(path) as z:
        return pq_from_state({key: z[key] for key in z.files}, device)


def _dense_grid_to_csr(list_codes, list_ids, counts):
    """A v1/v2 dense (C, cap, Bs) list grid -> the CSR tile layout:
    (csr_codes uint8[T, Bs_pad, 128], csr_ids int32[T * 128],
    tile_offsets int32[C], counts int32[C]), one guard tile appended,
    as ``tinyknn_tpu.io._dense_grid_to_csr`` builds it."""
    C, _, Bs = list_codes.shape
    counts = np.asarray(counts).astype(np.int64)
    ntiles = -(-counts // LANE_TILE)
    toff = np.zeros(C, np.int64)
    np.cumsum(ntiles[:-1], out=toff[1:])
    total = int(ntiles.sum()) + 1
    flat_ids = np.full(total * LANE_TILE, -1, np.int32)
    flat_codes = np.zeros((total * LANE_TILE, Bs), np.uint8)
    for c in range(C):
        L, s = int(counts[c]), int(toff[c]) * LANE_TILE
        flat_ids[s:s + L] = list_ids[c, :L]
        flat_codes[s:s + L] = list_codes[c, :L]
    rows = np.pad(flat_codes, ((0, 0), (0, round_up(Bs, 8) - Bs)))
    csr_codes = rows.reshape(total, LANE_TILE, -1).transpose(0, 2, 1)
    return (np.ascontiguousarray(csr_codes), flat_ids,
            toff.astype(np.int32), counts.astype(np.int32))


def _csr_lists(state, version: int):
    """(csr_codes, csr_ids, tile_offsets, list_counts) host arrays of an
    archive of any format."""
    if version >= 3:
        return tuple(np.asarray(state[key]) for key in (
            "csr_codes", "csr_ids", "tile_offsets", "list_counts"))
    codes = np.asarray(state["list_codes"])
    if version < 2:  # v1: one code per byte
        codes = codes[..., 0::2] | (codes[..., 1::2] << 4)
    list_ids = np.asarray(state["list_ids"])
    counts = (np.asarray(state["list_counts"]) if "list_counts" in state
              else np.sum(list_ids >= 0, axis=1))
    return _dense_grid_to_csr(codes, list_ids, counts)


def _ivf_restore(state, cls, **where):
    """An index of class ``cls`` (``IVF`` or ``ShardedIVF``; ``where``:
    its placement arguments) holding an archive's arrays as one
    single-device index on its ``device``, without derived state."""
    version = _format(state, _REQUIRED)
    _check_keys(state, _REQUIRED[version], _OPTIONAL[version], b"ivf")
    meta = {**_IVF_DEFAULTS, **_meta(state, "ivf_meta")}
    ivf = cls(meta["metric"], meta["n_clusters"], seed=meta["seed"],
              kmeans_iters=meta["kmeans_iters"],
              queries_per_cluster=meta["queries_per_cluster"],
              pass1_method=meta["pass1_method"],
              scan_impl=meta["scan_impl"], fold_mult=meta["fold_mult"],
              rescore_rows=meta["rescore_rows"],
              scan_budget_bytes=meta["scan_budget_bytes"], **where)
    device = ivf.device

    def tensor(key, dtype):
        return torch.as_tensor(np.asarray(state[key]), dtype=dtype,
                               device=device)

    ivf.pq = _pq_restore(state, device)
    ivf.all_centers = tensor("all_centers", torch.float32)
    ivf.active_centers = tensor("active_centers", torch.float32)
    ivf.data = tensor("data", torch.float32)
    if "labels" in state:
        ivf.labels = tensor("labels", torch.int64)
    csr_codes, csr_ids, tile_offsets, list_counts = _csr_lists(state, version)
    ivf._set_lists(torch.as_tensor(csr_codes, dtype=torch.uint8),
                   torch.as_tensor(csr_ids, dtype=torch.int32),
                   tile_offsets, list_counts)
    ivf.build_probes = meta.get("build_probes")
    if ivf.build_probes is None:
        total = int(np.asarray(list_counts, np.int64).sum())
        ivf.build_probes = max(1, round(total / max(1, ivf.data.shape[0])))
    ivf.build_probes = int(ivf.build_probes)
    return ivf


def ivf_from_state(state: dict[str, np.ndarray], device,
                   skip_derived: bool = False) -> IVF:
    """A port ``IVF`` on ``device`` from the arrays of an archive (v3, or
    a v1/v2 dense grid; optional ``labels`` and ``pq_R`` included). It
    computes what the JAX index computes. Metadata fields missing from
    the archive take the JAX loader's defaults; a missing
    ``build_probes`` is the lists' mean multiplicity, sum(list_counts)
    / n_rows, as build() places every point in exactly build_probes
    lists. Derived state (the exact engine's vector tiles, the
    rescore_rows copy) is rebuilt from (data, csr_ids), as the JAX
    loader does, unless ``skip_derived``: the index then has neither
    and cannot serve an exact-engine query before
    ``set_scan_impl('exact')``."""
    ivf = _ivf_restore(state, IVF, device=torch.device(device))
    if skip_derived:
        return ivf
    return ivf.set_scan_impl(ivf.scan_impl).set_rescore_rows(
        ivf.rescore_rows)


def load_ivf(path, device, skip_derived: bool = False) -> IVF:
    """``np.load`` of an IVF archive + ``ivf_from_state``."""
    with np.load(path) as z:
        return ivf_from_state({key: z[key] for key in z.files}, device,
                              skip_derived)


def sharded_ivf_from_state(state: dict[str, np.ndarray], mesh=None,
                           axis="shards", query_axis=None) -> ShardedIVF:
    """A ``ShardedIVF`` placed over ``mesh`` (default: the visible CUDA
    devices) from the arrays of an archive, whether a sharded or a
    single-device index wrote it. The single-device derived state is
    never built: placing derives each shard's own. The unsharded state
    (data, codebooks) stays on the mesh's first device."""
    ivf = _ivf_restore(state, ShardedIVF, mesh=mesh, axis=axis,
                       query_axis=query_axis)
    ivf._place()
    return ivf


def load_sharded_ivf(path, mesh=None, axis="shards",
                     query_axis=None) -> ShardedIVF:
    """``np.load`` of an IVF archive + ``sharded_ivf_from_state``: the
    mesh need not be the one the index was saved from."""
    with np.load(path) as z:
        return sharded_ivf_from_state({key: z[key] for key in z.files}, mesh,
                                      axis, query_axis)
