"""Load IVF archives (counterpart of tinyknn_tpu/io.py, read side).

``tinyknn_tpu.io.save_ivf`` writes a built index as a v3 npz archive:
CSR-tiled lists plus the PQ codebooks and metadata. The port reads the
same archives, so an index built by the JAX package serves from the
port unchanged. Only v3 is read; saving from the port, FastPQ archives
and the sharded loader are not ported yet (ROADMAP queue 1, item 4).
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


def _meta(state, key) -> dict:
    return json.loads(bytes(np.asarray(state[key])).decode())


def ivf_from_state(state: dict[str, np.ndarray], device) -> IVF:
    """A port ``IVF`` on ``device`` from the arrays of a v3 archive
    (the keys ``tinyknn_tpu.io.save_ivf`` writes, optional ``labels``
    and ``pq_R`` included). It computes what the JAX index computes."""
    keys = set(state)
    if not _REQUIRED <= keys or keys - _REQUIRED - _OPTIONAL:
        raise ValueError(
            f"not an IVF archive: missing {sorted(_REQUIRED - keys)}, "
            f"unknown {sorted(keys - _REQUIRED - _OPTIONAL)}")
    if int(state["format"]) != FORMAT_VERSION:
        raise ValueError(f"only format v{FORMAT_VERSION} archives are read, "
                         f"not v{int(state['format'])}")
    if bytes(np.asarray(state["kind"])) != b"ivf":
        raise ValueError("not an IVF archive")
    meta, pq_meta = _meta(state, "ivf_meta"), _meta(state, "pq_meta")
    device = torch.device(device)

    def tensor(key, dtype=None):
        return torch.as_tensor(np.asarray(state[key]), dtype=dtype,
                               device=device)

    pq_kw = dict(dims_per_block=pq_meta["dims_per_block"],
                 use_kmeans=pq_meta["use_kmeans"],
                 rotate_dim=pq_meta["rotate_dim"], seed=pq_meta["seed"],
                 kmeans_iters=pq_meta["kmeans_iters"],
                 kmeans_n_init=pq_meta["kmeans_n_init"],
                 table_dtype=pq_meta["table_dtype"], device=device)
    ivf = IVF(meta["metric"], meta["n_clusters"], pq=FastPQ(**pq_kw),
              seed=meta["seed"], kmeans_iters=meta["kmeans_iters"],
              queries_per_cluster=meta["queries_per_cluster"],
              pass1_method=meta["pass1_method"],
              scan_impl=meta["scan_impl"], fold_mult=meta["fold_mult"],
              rescore_rows=meta["rescore_rows"],
              scan_budget_bytes=meta["scan_budget_bytes"], device=device)
    pq = ivf.pq
    pq.center_blocks = tensor("pq_center_blocks", torch.float32)
    B, _, dpb = pq.center_blocks.shape
    pq.centers = pq.center_blocks.transpose(0, 1).reshape(16, B * dpb)
    pq.sqrt_n_blocks = float(np.sqrt(B))
    if "pq_R" in state:
        pq.R = tensor("pq_R", torch.float32)
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
    return ivf


def load_ivf(path, device) -> IVF:
    """``np.load`` of a v3 archive + ``ivf_from_state``."""
    with np.load(path) as z:
        return ivf_from_state({key: z[key] for key in z.files}, device)
