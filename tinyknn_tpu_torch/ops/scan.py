"""The FastPQ full-scan estimate dispatcher (counterpart of
tinyknn_tpu/ops/scan.py).

    est[q, i] = sum_b tables[q, b, codes[i, b]]

for every query q and every code row i. ``backend`` keeps the JAX
package's names: 'pallas' is the kernel route (K3,
``estimate_scan_tiled``, or what ``register_pallas_impl`` put in its
place), 'xla' the plain one-hot product ``estimate_scan_xla``, and
'auto' lets the device of the tensors decide, as for every kernel of
the port: CUDA tensors launch K3, CPU tensors run its plain torch
version. Float tables go through K3 as well (the JAX package sends them
to XLA). ``estimate_scan_saturating`` emulates the reference's
saturating int8 SIMD sums, the test suite's oracle.
"""

from __future__ import annotations

import torch

from .kernels import estimate_scan_tiled, tile_codes
from .packing import pack_codes, unpack_codes

BACKENDS = ("auto", "pallas", "xla")


def _estimate_tiled(codes: torch.Tensor, tables: torch.Tensor,
                    packed: bool) -> torch.Tensor:
    """``estimate_scan_tiled`` over ``codes`` (kernel or plain version by
    device). An odd block count (which cannot be nibble-packed) gets a
    zero code column and a zero table block, so the card runs the kernel
    there too."""
    n = codes.shape[0]
    if not packed:
        if codes.shape[-1] % 2:
            codes = torch.nn.functional.pad(codes, (0, 1))
        codes = pack_codes(codes)
    if tables.shape[1] % 2:
        tables = torch.nn.functional.pad(tables, (0, 0, 0, 1))
    return estimate_scan_tiled(tile_codes(codes), tables)[:, :n]


def _kernel_route(codes: torch.Tensor, tables: torch.Tensor,
                  packed: bool) -> torch.Tensor:
    """The default 'pallas' route: K3, on CUDA tensors only."""
    if tables.device.type != "cuda":
        raise ValueError(f"backend='pallas' launches the K3 kernel and "
                         f"needs CUDA tensors, not {tables.device}; use "
                         f"'auto' or 'xla' on the CPU")
    return _estimate_tiled(codes, tables, packed)


_PALLAS_IMPL = _kernel_route


def register_pallas_impl(fn):
    """Make ``fn(codes, tables, packed)`` what ``backend='pallas'``
    calls (the default is the K3 route, ``_kernel_route``)."""
    global _PALLAS_IMPL
    _PALLAS_IMPL = fn


def estimate_scan_xla(codes: torch.Tensor, tables: torch.Tensor,
                      packed: bool = False) -> torch.Tensor:
    """The plain one-hot product (the JAX package's XLA backend).

    codes: uint8[n, B] (0..15), or uint8[n, B/2] nibble-packed when
    ``packed``; tables: [Q, B, 16]. int8 tables give int32[Q, n]: the
    int8 one-hot's products summed exactly (in f64, which holds every
    such sum and runs on any device), as the JAX function's int32
    accumulation does. Float tables give f32[Q, n]: a bf16 one-hot
    times the tables, summed in f32 (products of 0 or 1 are exact, so
    only the order of the f32 sums can differ from XLA's). A plain
    version for tests; no path of the package calls it."""
    if packed:
        codes = unpack_codes(codes)
    floating = tables.dtype.is_floating_point
    acc = torch.float32 if floating else torch.float64
    onehot = torch.nn.functional.one_hot(codes.long(), 16)
    a = onehot.reshape(codes.shape[0], -1).to(
        torch.bfloat16 if floating else torch.int8).to(acc)
    b = tables.reshape(tables.shape[0], -1).to(acc)
    out = b @ a.T
    return out if floating else out.to(torch.int32)


def estimate_scan(codes: torch.Tensor, tables: torch.Tensor,
                  backend: str = "auto", packed: bool = False):
    """Batched PQ estimate.

    codes: uint8[n, B] (values 0..15), or uint8[n, B/2] nibble-packed
    when ``packed``; tables: [Q, B, 16] int8, bf16 or f32. Returns
    int32[Q, n] for int8 tables, f32[Q, n] for float ones.

    ``backend``: 'auto' (K3 on CUDA tensors, its plain version on CPU
    ones), 'pallas' (the registered kernel route; the default raises on
    CPU tensors, it never falls back) or 'xla' (``estimate_scan_xla``).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if backend == "xla":
        return estimate_scan_xla(codes, tables, packed)
    if backend == "pallas":
        return _PALLAS_IMPL(codes, tables, packed)
    return _estimate_tiled(codes, tables, packed)


def estimate_scan_saturating(codes: torch.Tensor, tables_u8: torch.Tensor,
                             signed: bool, lanes: int = 1) -> torch.Tensor:
    """Emulation of the reference's saturating int8 accumulation (slow).

    lanes=1 is the SSE semantics: the blocks added in order, the sum
    clamped to the int8 (``signed``) or uint8 range after every add.
    lanes=2 is the AVX two-lane quirk: blocks split by bit 1 of the block
    index into two lanes that saturate independently, then add with one
    more clamp. ``tables_u8`` [Q, B, 16] holds the raw table bytes as the
    reference's kernels see them; ``signed`` picks the int8 or uint8 view.
    codes: uint8[n, B]. Returns int32[Q, n] within the int8 / uint8 range.
    """
    if lanes not in (1, 2):
        raise ValueError(f"lanes must be 1 or 2, not {lanes}")
    lo, hi = (-128, 127) if signed else (0, 255)
    t = tables_u8.to(torch.uint8)
    t = (t.view(torch.int8) if signed else t).to(torch.int32)   # (Q, B, 16)
    B = codes.shape[1]
    blocks = torch.arange(B, device=codes.device)
    gathered = t[:, blocks[None, :], codes.long()]              # (Q, n, B)

    def lane_sum(vals):
        acc = torch.zeros(vals.shape[:2], dtype=torch.int32,
                          device=vals.device)
        for b in range(vals.shape[2]):
            acc = (acc + vals[:, :, b]).clamp(lo, hi)
        return acc

    if lanes == 1:
        return lane_sum(gathered)
    second = blocks % 4 >= 2                     # bit 1 of the block index
    return (lane_sum(gathered[:, :, ~second])
            + lane_sum(gathered[:, :, second])).clamp(lo, hi)
