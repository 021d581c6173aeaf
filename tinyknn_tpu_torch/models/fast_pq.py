"""FastPQ: 4-bit product quantizer (counterpart of
tinyknn_tpu/models/fast_pq.py, fit, encode and distance tables).

Fits 16 centers per block of ``dims_per_block`` dims, encodes rows to
nibble-packed 4-bit codes and builds per-query distance tables (int8,
bf16 or f32). All state lives on the device given at construction.
The full-scan search (``distance_table``, ``search``) is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.kmeans import blockwise_kmeans
from ..ops.packing import pack_codes, unpack_codes
from ..ops.quantization import (
    QuantizedTables,
    block_dists_blocked,
    quantize_tables_signed,
    quantize_tables_unsigned,
    tables_bf16,
)
from ..utils.bruteforce import fp32_matmuls
from ..utils.padding import pad2, round_up

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
    """4-bit product quantizer, state on ``device``."""

    def __init__(self, dims_per_block=2, use_kmeans=True, rotate_dim=64,
                 seed=0, kmeans_iters=25, kmeans_n_init=2,
                 table_dtype="int8", device="cpu"):
        if table_dtype not in ("int8", "bf16", "f32"):
            raise ValueError(f"table_dtype must be int8, bf16 or f32, "
                             f"not {table_dtype!r}")
        self.dims_per_block = dims_per_block
        self.use_kmeans = use_kmeans
        self.rotate_dim = rotate_dim
        self.seed = seed
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
        then fits 16 centers per block, all blocks at once.
        """
        del verbose
        if not self.use_kmeans:
            raise NotImplementedError(
                "use_kmeans=False (the fixed Gaussian code) is not ported "
                "yet: ROADMAP queue 1, item 10")
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
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.center_blocks = blockwise_kmeans(
            cols, generator=gen, k=16, iters=self.kmeans_iters,
            n_init=self.kmeans_n_init)                      # (B, 16, dpb)
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
