"""The FastPQ full-scan estimate dispatcher (counterpart of
tinyknn_tpu/ops/scan.py).

    est[q, i] = sum_b tables[q, b, codes[i, b]]

for every query q and every code row i. The JAX package picks an XLA
one-hot matmul or its Pallas kernel by ``backend``; here the device of
the tensors decides, as for every kernel of the port: CUDA tensors
launch K3 (``estimate_scan_tiled``), CPU tensors run its plain torch
version, which plays the part of ``estimate_scan_xla``. Float tables go
through K3 as well (the JAX package sends them to XLA).
"""

from __future__ import annotations

import torch

from .kernels import estimate_scan_tiled, tile_codes
from .packing import pack_codes


def estimate_scan(codes: torch.Tensor, tables: torch.Tensor,
                  packed: bool = False):
    """Batched PQ estimate.

    codes: uint8[n, B] (values 0..15), or uint8[n, B/2] nibble-packed
    when ``packed``; tables: [Q, B, 16] int8, bf16 or f32. Returns
    int32[Q, n] for int8 tables, f32[Q, n] for float ones.

    An odd block count (which cannot be nibble-packed) gets a zero code
    column and a zero table block, so the card runs the kernel there
    too.
    """
    n = codes.shape[0]
    if not packed:
        if codes.shape[-1] % 2:
            codes = torch.nn.functional.pad(codes, (0, 1))
        codes = pack_codes(codes)
    if tables.shape[1] % 2:
        tables = torch.nn.functional.pad(tables, (0, 0, 0, 1))
    return estimate_scan_tiled(tile_codes(codes), tables)[:, :n]
