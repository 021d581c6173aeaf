"""FastPQ: 4-bit product quantizer (counterpart of
tinyknn_tpu/models/fast_pq.py, fit, encode and distance tables).

Fits 16 centers per block of ``dims_per_block`` dims, encodes rows to
nibble-packed 4-bit codes, builds per-query distance tables (int8,
bf16 or f32) and searches the whole code matrix: a full-scan estimate
(kernel K3, ``ops.scan.estimate_scan``) and the two-pass top-k, whose
pass 1 can also run through K1 (``fold_topk_tiled``). All state lives
on the device given at construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels import fold_topk_tiled, tile_codes
from ..ops.kmeans import blockwise_kmeans
from ..ops.packing import pack_codes, unpack_codes
from ..ops.quantization import (
    QuantizedTables,
    block_dists_blocked,
    dequantize_estimates,
    quantize_tables_signed,
    quantize_tables_unsigned,
    tables_bf16,
)
from ..ops.scan import estimate_scan
from ..ops.topk import smallest_k
from ..utils.bruteforce import fp32_matmuls
from ..utils.padding import pad2, round_up

BACKENDS = ("auto", "xla", "pallas")  # the JAX package's scan backends
ROW_PAD = 8       # row alignment of the code matrix
BLOCK_PAD = 8     # block-count alignment of the code matrix
ENCODE_CHUNK = 65536  # rows encoded per step (bounds the (rows, B, 16) block)


class TransformedData(NamedTuple):
    """Encoded dataset: true row count + nibble-packed code matrix
    ``uint8[n_pad, n_blocks // 2]`` (zero rows beyond ``size``)."""
    size: int
    packed: torch.Tensor

    @property
    def codes(self):
        """Unpacked uint8[n_pad, n_blocks] view (values 0..15)."""
        return unpack_codes(self.packed)


def as_f32(x, device) -> torch.Tensor:
    """NumPy array or tensor -> float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=torch.float32, device=device)


class FastPQ:
    """4-bit product quantizer, state on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, dims_per_block=2, use_kmeans=True, rotate_dim=64,
                 seed=0, backend="auto", kmeans_iters=25, kmeans_n_init=2,
                 table_dtype="int8", device="cuda"):
        """``backend``: the JAX package's scan backend, kept so its
        archives load; the port routes by device and ignores it."""
        if table_dtype not in ("int8", "bf16", "f32"):
            raise ValueError(f"table_dtype must be int8, bf16 or f32, "
                             f"not {table_dtype!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not "
                             f"{backend!r}")
        self.dims_per_block = dims_per_block
        self.use_kmeans = use_kmeans
        self.rotate_dim = rotate_dim
        self.seed = seed
        self.backend = backend
        self.kmeans_iters = kmeans_iters
        self.kmeans_n_init = kmeans_n_init
        self.table_dtype = table_dtype
        self.device = torch.device(device)
        self.centers = None        # (16, d) f32
        self.center_blocks = None  # (B, 16, dpb) f32
        self.sqrt_n_blocks = None
        self.R = None              # optional (d_out, d_in) rotation

    def fit(self, data, verbose=False):
        """Fit per-block codebooks.

        Pads rows and columns, applies a random orthogonal rotation or
        projection to ``rotate_dim`` dims unless the raw dimensionality
        is exactly 100 (the GloVe case, where no rotation is applied),
        then fits 16 centers per block, all blocks at once, by k-means
        (``use_kmeans``) or as the fixed ring code matched to each
        block's mean and covariance (dims_per_block=2 only).
        """
        del verbose
        fp32_matmuls()
        data = as_f32(data, self.device)
        if data.numel() == 0:
            raise ValueError("Can't fit no data")
        true_n, true_d = data.shape
        dpb = self.dims_per_block
        data = pad2(data, ROW_PAD, BLOCK_PAD * dpb)
        n, d = data.shape
        if self.rotate_dim is not None and true_d != 100:
            # the same rotation as the JAX package draws from this seed
            rng = np.random.default_rng(self.seed)
            q, _ = np.linalg.qr(rng.standard_normal((d, d)))
            R = np.ascontiguousarray(q.T, dtype=np.float32)
            if d > self.rotate_dim:
                d = round_up(self.rotate_dim, BLOCK_PAD * dpb)
                R = R[:d]
            self.R = torch.as_tensor(R, device=self.device)
            data = data @ self.R.T
        B = d // dpb
        cols = data.reshape(n, B, dpb).transpose(0, 1).contiguous()
        if self.use_kmeans:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            self.center_blocks = blockwise_kmeans(
                cols, generator=gen, k=16, iters=self.kmeans_iters,
                n_init=self.kmeans_n_init)                  # (B, 16, dpb)
        else:
            self.center_blocks = torch.as_tensor(
                _fixed_gaussian_code(cols.cpu().numpy(), dpb),
                device=self.device)
        self.centers = self.center_blocks.transpose(0, 1).reshape(16, d)
        self.sqrt_n_blocks = float(np.sqrt(B))
        return self

    def fit_transform(self, data, verbose=False):
        return self.fit(data, verbose).transform(data, verbose)

    def transform(self, data, verbose=False) -> TransformedData:
        """Encode rows to nibble-packed 4-bit codes on the device."""
        del verbose
        if self.centers is None:
            raise RuntimeError("PQ has not been fitted")
        fp32_matmuls()
        data = as_f32(data, self.device)
        if data.numel() == 0:
            B = self.center_blocks.shape[0]
            return TransformedData(0, torch.zeros(
                (0, B // 2), dtype=torch.uint8, device=self.device))
        true_n = data.shape[0]
        data = pad2(data, ROW_PAD, BLOCK_PAD * self.dims_per_block)
        codes = _encode(data, self.center_blocks, self.R,
                        self.dims_per_block)
        return TransformedData(true_n, pack_codes(codes))

    # ----------------------------------------------------- distance tables

    def distance_table(self, q):
        """Signed int8 (or the table_dtype's) distance tables for a
        query (d,) or a batch (Q, d)."""
        return self._table(q, signed=True)

    def udistance_table(self, q):
        """Tables in the unsigned int8 scheme."""
        return self._table(q, signed=False)

    def _table(self, q, signed: bool):
        if self.centers is None:
            raise RuntimeError("PQ has not been fitted")
        fp32_matmuls()
        q = as_f32(q, self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        qt = _build_tables(q, self.center_blocks, self.R,
                           self.dims_per_block, signed, self.table_dtype)
        return _FastDistanceTable(self, qt, q, single)

    # ------------------------------------------------------------ search

    def search(self, q, transformed_data, data, k=1, rescore=None,
               method="auto", signed=True):
        """Tables + full-scan estimate + two-pass top-k in one call:
        ``distance_table(q).top(...)`` for the serving path. Returns
        int32 (Q, k) row indices, or (k,) for a single query."""
        if self.centers is None:
            raise RuntimeError("PQ has not been fitted")
        fp32_matmuls()
        q = as_f32(q, self.device)
        single = q.ndim == 1
        if single:
            q = q[None]
        true_n, codes = transformed_data
        data = as_f32(data, self.device)
        k, rescore = _top_widths(true_n, k, rescore)
        idx = _fused_search(q, codes, data, self.center_blocks, self.R,
                            self.dims_per_block, signed, true_n, k, rescore,
                            _resolve_method(method), self.table_dtype)
        return idx[0] if single else idx


def _fixed_gaussian_code(cols, dpb: int):
    """Data-independent ring code for dims_per_block=2 (NumPy, as in the
    JAX package): a fixed 16-point code (center + rings of 6 and 9)
    affinely matched to each block's mean and covariance through a
    Cholesky factor. cols: (B, n, 2) -> f32 (B, 16, 2)."""
    if dpb != 2:
        raise ValueError("the fixed code is only defined for "
                         "dims_per_block=2")
    base = np.array(
        [(0.0, 0.0)]
        + [(r * np.cos(th), r * np.sin(th))
           for r, num in zip([1, 2], [6, 9])
           for th in np.linspace(0, 2 * np.pi, num, endpoint=False)],
        dtype=np.float64)
    out = []
    for col in cols:  # (n, 2)
        mu = np.mean(col, axis=0)
        S = np.cov(col.T, bias=True)
        S = np.atleast_2d(S) + 1e-9 * np.eye(2)
        out.append(base @ np.linalg.cholesky(S).T + mu)
    return np.stack(out).astype(np.float32)  # (B, 16, 2)


def _encode(data, center_blocks, R, dpb: int):
    """Nearest of the 16 centers per block, uint8[n, B]; ties go to the
    lower center, as ``jnp.argmin``'s do."""
    if R is not None:
        data = data @ R.T
    n, d = data.shape
    B = d // dpb
    cn = torch.einsum("bkd,bkd->bk", center_blocks, center_blocks)
    out = []
    for i in range(0, n, ENCODE_CHUNK):
        cols = data[i:i + ENCODE_CHUNK].reshape(-1, B, dpb)
        # argmin over 16 centers per block: -2<x,c> + ||c||^2 suffices
        d2 = (torch.einsum("nbd,bkd->nbk", cols, center_blocks) * -2.0
              + cn[None])
        out.append(torch.argmin(d2, dim=2).to(torch.uint8))
    return torch.cat(out)


def _build_tables(q, center_blocks, R, dpb: int, signed: bool,
                  table_dtype: str = "int8") -> QuantizedTables:
    """Per-query distance tables (Q, B, 16) in ``table_dtype``."""
    Q, true_d = q.shape
    B = center_blocks.shape[0]
    d_in = B * dpb if R is None else R.shape[1]
    q = torch.nn.functional.pad(q, (0, d_in - true_d))
    if R is not None:
        q = q @ R.T
    dists = block_dists_blocked(q.reshape(Q, B, dpb), center_blocks)
    if table_dtype == "bf16":
        return tables_bf16(dists)
    if table_dtype == "f32":
        return QuantizedTables(
            dists, torch.zeros((Q,), dtype=torch.float32, device=q.device),
            torch.ones((Q,), dtype=torch.float32, device=q.device), True)
    if signed:
        return quantize_tables_signed(dists)
    return quantize_tables_unsigned(dists)


class _FastDistanceTable:
    """Batched distance tables of Q queries (the JAX package's
    ``_FastDistanceTable``)."""

    def __init__(self, pq: FastPQ, qt: QuantizedTables, raw_q, single: bool):
        self.pq = pq
        self.qt = qt
        self.raw_q = raw_q
        self.single = single

    @property
    def tables(self):
        return self.qt.tables

    def __repr__(self):
        return (f"FastDistanceTable(Q={self.qt.tables.shape[0]}, "
                f"n_blocks={self.qt.n_blocks}, signed={self.qt.signed})")

    def estimate_distances(self, transformed_data, out=None, rescale=False):
        """Full-scan estimates (Q, n): int32 table sums for int8 tables
        (f32 for float ones), or approximate squared distances when
        ``rescale``. ``out`` is accepted for API parity and ignored."""
        del out
        true_n, codes = transformed_data
        est = estimate_scan(codes, self.qt.tables, packed=True)[:, :true_n]
        if rescale:
            est = dequantize_estimates(est, self.qt)
        return est[0] if self.single else est

    def top(self, transformed_data, data, k=1, rescore=None, method="auto"):
        """Two-pass top-k: the ``rescore`` best estimates, then exact fp32
        distances. Returns int32 (Q, k) row indices, or (k,) for a single
        query. ``method``: 'exact', or 'approx' (through K1's fold, see
        ``_two_pass_top``); 'auto' is 'exact'."""
        true_n, codes = transformed_data
        data = as_f32(data, self.pq.device)
        if data.shape[0] != true_n:
            raise ValueError(f"data has {data.shape[0]} rows, the codes "
                             f"{true_n}")
        k, rescore = _top_widths(true_n, k, rescore)
        idx = _two_pass_top(codes, self.qt.tables, self.raw_q, data, true_n,
                            k, rescore, _resolve_method(method))
        return idx[0] if self.single else idx


def _top_widths(true_n: int, k: int, rescore):
    """(k, rescore) of a two-pass search over ``true_n`` rows: k capped
    at true_n, rescore defaulting to 2k + 10."""
    k = min(k, true_n)
    if not rescore:
        rescore = min(2 * k + 10, true_n)
    if not true_n >= rescore >= k:
        raise ValueError(f"need true_n >= rescore >= k, not {true_n}, "
                         f"{rescore}, {k}")
    return k, rescore


def _resolve_method(method: str) -> str:
    """Pass-1 method: 'auto' is 'exact' on every device (the card has no
    approx_max_k)."""
    if method == "auto":
        return "exact"
    if method not in ("exact", "approx"):
        raise ValueError(f"method must be auto, exact or approx, not "
                         f"{method!r}")
    return method


def pass1_topk(vals, k: int, method: str):
    """Pass-1 candidates: (values, indices) of the k smallest ``vals``
    along the last axis. This is the one place where 'approx' would
    select differently from 'exact' (the JAX package's ``approx_max_k``
    over negated values); the port has no approximate selection, so
    both methods select exactly."""
    _resolve_method(method)
    return smallest_k(vals, k)


def _fused_search(q, codes, data, center_blocks, R, dpb: int, signed: bool,
                  true_n: int, k: int, rescore: int, method: str,
                  table_dtype: str = "int8"):
    qt = _build_tables(q, center_blocks, R, dpb, signed, table_dtype)
    return _two_pass_top(codes, qt.tables, q, data, true_n, k, rescore,
                         method)


def _rescore(cand, raw_q, data, valid=None):
    """Exact fp32 squared distances of the candidate rows (Q, r); +inf
    where not ``valid``."""
    diff = data[cand.long()] - raw_q[:, None, :]          # (Q, r, d)
    d2 = torch.einsum("qrd,qrd->qr", diff, diff)
    return d2 if valid is None else torch.where(valid, d2, float("inf"))


def _two_pass_top(codes, tables, raw_q, data, true_n: int, k: int,
                  rescore: int, method: str):
    """Pass 1 picks ``rescore`` candidates by estimate, pass 2 keeps the
    k nearest by exact fp32 distance. int32 (Q, k) row indices.

    ``method='approx'`` with int8 tables and rescore > k takes pass 1
    through K1 (``fold_topk_tiled``), on every device: the (Q, n)
    estimate matrix is never written. This is the JAX package's route
    for backend 'pallas'. Otherwise K3 writes the estimates and pass 1
    selects from them."""
    if method == "approx" and tables.dtype == torch.int8 and rescore > k:
        cand, valid = fold_topk_tiled(tile_codes(codes), tables, true_n,
                                      rescore)
        _, best = smallest_k(_rescore(cand, raw_q, data, valid), k)
        return torch.gather(cand, 1, best)
    est = estimate_scan(codes, tables, packed=True)            # (Q, n_pad)
    n_pad = codes.shape[0]
    if n_pad > true_n:
        big = (float("inf") if est.dtype.is_floating_point
               else torch.iinfo(torch.int32).max)
        est = est.masked_fill(
            torch.arange(n_pad, device=est.device) >= true_n, big)
    _, cand = pass1_topk(est, rescore, method)              # (Q, rescore)
    if rescore > k:
        _, best = smallest_k(_rescore(cand, raw_q, data), k)
        cand = torch.gather(cand, 1, best)
    return cand.to(torch.int32)
