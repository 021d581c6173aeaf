"""Load IVF and FastPQ archives (counterpart of tinyknn_tpu/io.py, read
side).

``tinyknn_tpu.io.save_ivf`` writes a built index as a v3 npz archive:
CSR-tiled lists plus the PQ codebooks and metadata;
``tinyknn_tpu.io.save_pq`` writes a fitted FastPQ (kind ``fastpq``).
The port reads the same archives, so an index or a quantizer fitted by
the JAX package serves from the port unchanged. Only v3 is read; saving
from the port and the sharded loader are not ported yet (ROADMAP
queue 1, item 4).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .models.fast_pq import FastPQ
from .models.ivf import IVF

FORMAT_VERSION = 3
_REQUIRED = frozenset({
    "format", "kind", "ivf_meta", "all_centers", "active_centers",
    "csr_codes", "csr_ids", "tile_offsets", "list_counts", "data",
    "pq_center_blocks", "pq_meta"})
_OPTIONAL = frozenset({"labels", "pq_R"})
_PQ_REQUIRED = frozenset({"format", "kind", "pq_center_blocks", "pq_meta"})


def _meta(state, key) -> dict:
    return json.loads(bytes(np.asarray(state[key])).decode())


def _check_keys(state, required, optional, kind: bytes):
    keys = set(state)
    if not required <= keys or keys - required - optional:
        raise ValueError(
            f"not a {kind.decode()} archive: missing "
            f"{sorted(required - keys)}, unknown "
            f"{sorted(keys - required - optional)}")
    if int(state["format"]) != FORMAT_VERSION:
        raise ValueError(f"only format v{FORMAT_VERSION} archives are read, "
                         f"not v{int(state['format'])}")
    if bytes(np.asarray(state["kind"])) != kind:
        raise ValueError(f"not a {kind.decode()} archive")


def _pq_restore(state, device: torch.device) -> FastPQ:
    """A fitted port FastPQ on ``device`` from the ``pq_*`` arrays."""
    meta = _meta(state, "pq_meta")
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
    ``kind=fastpq`` archive (the keys ``tinyknn_tpu.io.save_pq`` writes,
    optional ``pq_R`` included). Its ``backend`` is kept and routes
    nothing."""
    _check_keys(state, _PQ_REQUIRED, frozenset({"pq_R"}), b"fastpq")
    return _pq_restore(state, torch.device(device))


def load_pq(path, device) -> FastPQ:
    """``np.load`` of a v3 FastPQ archive + ``pq_from_state``."""
    with np.load(path) as z:
        return pq_from_state({key: z[key] for key in z.files}, device)


def ivf_from_state(state: dict[str, np.ndarray], device) -> IVF:
    """A port ``IVF`` on ``device`` from the arrays of a v3 archive
    (the keys ``tinyknn_tpu.io.save_ivf`` writes, optional ``labels``
    and ``pq_R`` included). It computes what the JAX index computes; an
    exact-engine index rebuilds its vector tiles from (data, csr_ids),
    as the JAX loader does."""
    _check_keys(state, _REQUIRED, _OPTIONAL, b"ivf")
    meta = _meta(state, "ivf_meta")
    device = torch.device(device)

    def tensor(key, dtype=None):
        return torch.as_tensor(np.asarray(state[key]), dtype=dtype,
                               device=device)

    pq = _pq_restore(state, device)
    ivf = IVF(meta["metric"], meta["n_clusters"], seed=meta["seed"],
              kmeans_iters=meta["kmeans_iters"],
              queries_per_cluster=meta["queries_per_cluster"],
              pass1_method=meta["pass1_method"],
              scan_impl=meta["scan_impl"], fold_mult=meta["fold_mult"],
              rescore_rows=meta["rescore_rows"],
              scan_budget_bytes=meta["scan_budget_bytes"], device=device)
    ivf.pq = pq
    ivf.build_probes = int(meta["build_probes"])
    ivf.all_centers = tensor("all_centers", torch.float32)
    ivf.active_centers = tensor("active_centers", torch.float32)
    ivf.data = tensor("data", torch.float32)
    if "labels" in state:
        ivf.labels = tensor("labels", torch.int64)
    ivf._set_lists(tensor("csr_codes", torch.uint8),
                   tensor("csr_ids", torch.int32),
                   np.asarray(state["tile_offsets"]),
                   np.asarray(state["list_counts"]))
    return ivf.set_scan_impl(ivf.scan_impl)


def load_ivf(path, device) -> IVF:
    """``np.load`` of a v3 archive + ``ivf_from_state``."""
    with np.load(path) as z:
        return ivf_from_state({key: z[key] for key in z.files}, device)
