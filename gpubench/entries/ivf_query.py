"""The entry ``ivf_query``: tinyknn_tpu_torch's IVF, fitted, built and
queried as a configuration says, and judged against the plain reference
(reference/ivf.py). The only module of the benchmark that imports the
program; from it the benchmark takes the index and its query, the
kernels' launch counters and their names, the query's pass counters,
and, to judge the build, the index's state after the window.

A configuration may give ``index.rotate_dim``: FastPQ's projection of
the vectors to that many dimensions (null: none; absent: FastPQ's
default of 64, which FastPQ skips at a raw dimension of 100). The
reference draws the same projection from it and ``PQ_SEED``."""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import judge
from ..data import make_clustered
from ..reference import ivf as ref

# the kernels' launch counters, by the name of the CUDA function that
# each launch runs (the name the profiler's trace shows)
KERNELS = {"scan_fold_csr": "scan_fold_csr_kernel",
           "scan_exact_csr": "scan_exact_csr_kernel"}
PQ_SEED = 0        # FastPQ's seed: its codebooks' k-means and projection
ROTATE_DIM = 64    # FastPQ's default rotate_dim


def query_config(config: dict) -> dict:
    """The settings the reference's query takes from a configuration."""
    ix = config["index"]
    return dict(config["query"], metric=config["dataset"]["metric"],
                engine="exact" if ix["scan_impl"] == "exact" else "pq",
                build_probes=ix["build_probes"], fold_mult=ix["fold_mult"],
                rotate_dim=ix.get("rotate_dim", ROTATE_DIM), pq_seed=PQ_SEED)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    """One IVF index of the configuration ``config`` on ``device``, over
    the configuration's corpus, made on the host and moved once."""

    def __init__(self, config: dict, device):
        from tinyknn_tpu_torch import IVF, FastPQ
        ds, ix = config["dataset"], config["index"]
        if ds["generator"] != "clustered":
            raise ValueError(f"unknown generator {ds['generator']!r}")
        ref.fp32_products()
        self.config, self.device = config, torch.device(device)
        self.k = config["query"]["k"]
        data, self.queries = make_clustered(ds["size"], ds["dim"],
                                            ds["n_queries"],
                                            seed=ds["data_seed"])
        self.X = torch.from_numpy(data).to(self.device)
        self.ivf = IVF(ds["metric"], ix["n_clusters"],
                       FastPQ(ix["dims_per_block"],
                              rotate_dim=query_config(config)["rotate_dim"],
                              seed=PQ_SEED, table_dtype=ix["table_dtype"],
                              device=self.device),
                       scan_impl=ix["scan_impl"], fold_mult=ix["fold_mult"],
                       device=self.device)

    def _timed(self, fn) -> float:
        _sync(self.device)
        t0 = time.perf_counter()
        fn()
        _sync(self.device)
        return time.perf_counter() - t0

    def setup(self) -> dict:
        """Fit and build; the seconds of each, host clock ending in a
        sync."""
        fit = self._timed(lambda: self.ivf.fit(self.X))
        build = self._timed(lambda: self.ivf.build(
            self.X, n_probes=self.config["index"]["build_probes"]))
        return {"fit": fit, "build": build}

    def query(self, q, mode: str):
        """Top-k ids of the (Q, d) host array ``q`` on the device."""
        qy = self.config["query"]
        return self.ivf.query(q, k=qy["k"], n_probes=qy["n_probes"],
                              pass_1=qy["pass_1"], mode=mode)

    @staticmethod
    def counters() -> dict:
        """Kernel launches so far, by kernel, and the program's own
        counters (``utils.timing.counters``: ``query.attempts``,
        ``query.rescued_pairs``, ...) as far as it keeps them."""
        from tinyknn_tpu_torch.ops import kernels
        from tinyknn_tpu_torch.utils import timing
        out = {name: getattr(kernels, name).launches for name in KERNELS}
        out.update(timing.counters)
        return out

    def claims(self) -> dict:
        """The index as built, one row per occupied list slot: the point
        id (``slot_ids``), the coarse center of its list
        (``slot_centers``, -1 where no center matches), its PQ codes
        (``slot_codes``, uint8 (m, B)) and, for the exact engine, its
        bf16 vector (``slot_vecs``); and the fit's ``centers`` and
        ``codebooks``."""
        ivf = self.ivf
        dev = ivf.csr_ids.device
        counts = ivf.list_counts.long()
        C = counts.shape[0]
        start = ivf.tile_offsets.long() * 128
        lists = torch.arange(C, device=dev).repeat_interleave(counts)
        first = torch.cumsum(counts, 0) - counts
        rows = start[lists] + torch.arange(int(counts.sum()), device=dev) \
            - first[lists]
        same = (ivf.active_centers[:, None, :]
                == ivf.all_centers[None, :, :]).all(-1)     # (C, K)
        center_of = torch.where(same.any(1), same.int().argmax(1), -1)
        B = ivf.pq.center_blocks.shape[0]
        packed = ivf.csr_codes.transpose(1, 2).reshape(-1,
                                                       ivf.csr_codes.shape[1])
        packed = packed[rows]
        codes = torch.stack([packed & 15, packed >> 4], -1).reshape(
            packed.shape[0], -1)[:, :B]
        vecs = None
        if ivf.csr_vecs is not None:
            v = ivf.csr_vecs
            vecs = v.transpose(1, 2).reshape(-1, v.shape[1])[rows]
        return {"slot_ids": ivf.csr_ids[rows].long(),
                "slot_centers": center_of[lists].long(),
                "slot_codes": codes, "slot_vecs": vecs,
                "centers": ivf.all_centers.clone(),
                "codebooks": ivf.pq.center_blocks.clone()}

    def judge(self, out, wl: dict, seed: int):
        """Read the index, free the program, and judge the window's
        answers ``out`` and the build against the reference: the numbers
        (each a share, 0 where the two agree), the recall over every
        answer, and one batch's view for the work counts."""
        claims = self.claims()
        del self.ivf
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        qcfg = query_config(self.config)
        index = ref.derive(self.X, claims["centers"], claims["codebooks"],
                           qcfg, ref.Precision())
        Qf = torch.from_numpy(self.queries).to(self.device)
        ids = torch.from_numpy(np.concatenate(out.ids).astype(np.int64)).to(
            self.device)
        rows = torch.from_numpy(np.concatenate(out.rows)).to(self.device)
        weights = torch.from_numpy(np.concatenate(out.weights)).to(
            self.device)
        numbers, qn = judge_numbers(index, qcfg, out.batch, Qf, claims, ids,
                                    rows, weights, wl["tau"])
        numbers.update(fit_numbers(index, claims, seed,
                                   qcfg["metric"] == "angular"))
        hits = judge.recall_hits(ids, rows, ref.truth(index.data, qn,
                                                      qcfg["k"]))
        batch = torch.from_numpy(out.rows[0]).to(self.device)
        view = SimpleNamespace(
            counts=index.counts, dim=self.config["dataset"]["dim"],
            code_dim=(index.R.shape[0] if index.R is not None
                      else self.config["dataset"]["dim"]),
            probes=ref.nearest(qn[batch], index.centers[index.active],
                               min(qcfg["n_probes"], index.active.shape[0]),
                               ref.Precision()),
            dims_per_block=self.config["index"]["dims_per_block"],
            pass_1=ref.plan(qcfg, index, batch.shape[0]).pass_1)
        return SimpleNamespace(
            numbers=numbers, view=view,
            recall=float((hits * weights).sum() / weights.sum()))


def judge_numbers(index, qcfg: dict, Q: int, Qf, claims: dict, ids, rows,
                  weights, tau: float):
    """The judge's numbers for answers ``ids`` (m, k) to test rows
    ``rows`` (each answer weighted by how many times it was given) and
    for the index ``claims`` describe, against the reference ``index``
    worked out from the same fit. ``Q``: the batch size the answers were
    asked at (it sets the exact engine's fold widths). Returns
    ``(numbers, normalized queries)``."""
    refs = [ref.answers(index, Qf, qcfg, ref.Precision(), Q=Q)[1]]
    qn = ref.normalize(Qf) if qcfg["metric"] == "angular" else Qf
    off = judge.answer_gaps(ids, rows, index.data, qn, refs, tau)
    numbers = {"answers_off": float((off * weights).sum() / weights.sum()),
               "lists_off": judge.lists_off(claims["slot_ids"],
                                            claims["slot_centers"],
                                            index.assign),
               "codes_off": judge.codes_off(claims["slot_ids"],
                                            claims["slot_codes"],
                                            index.codes)}
    if index.aug is not None:
        numbers["tiles_off"] = judge.tiles_off(
            claims["slot_ids"], claims["slot_vecs"], index.aug)
    return numbers, qn


def fit_numbers(index, claims: dict, seed: int, angular: bool) -> dict:
    """The fit judged by itself: the inertia of the program's coarse
    centers, and of its codebooks block by block over the projected
    block columns, over that of the reference's own k-means of the same
    data, seeded from the run."""
    gen = torch.Generator(device=index.data.device).manual_seed(seed)
    x = index.data
    centers = claims["centers"]
    own = ref.kmeans(x, centers.shape[0], gen)
    if angular:                              # the index's unit centers
        own = ref.normalize(own)
    cb = claims["codebooks"]
    B, _, dpb = cb.shape
    cols = ref.pad_blocks(ref.coded(x, index.R, ref.Precision()), B,
                          dpb).transpose(0, 1).contiguous()
    theirs = ref.block_inertia(cols, cb)
    mine = ref.block_inertia(cols, ref.block_kmeans(cols, cb.shape[1], gen))
    real = mine > 0
    return {"centers_fit_off": judge.fit_off(
                ref.kmeans_inertia(x, centers), ref.kmeans_inertia(x, own)),
            "codebooks_fit_off": judge.fit_off(theirs[real], mine[real])}
