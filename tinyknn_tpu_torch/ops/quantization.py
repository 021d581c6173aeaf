"""Distance tables and their int8 quantization (counterpart of
tinyknn_tpu/ops/quantization.py).

A PQ distance table holds, for one query, the squared distance from
the query's block to each of the 16 codebook centers of that block:
``dists[b, c] = ||q_b - center[b, c]||^2`` — shape (n_blocks, 16).
Batched over queries. The list scan sums table entries in int32 (or
f32 for bf16 tables), so the int8 format costs no overflow.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LN2 = 0.6931471805599453


class QuantizedTables(NamedTuple):
    """Batched quantized distance tables.

    tables: int8[(Q, n_blocks, 16)] (or bf16/f32 for the unquantized
        modes) — for 'unsigned' mode the stored value is (true - 128).
    shift:  f32[(Q,)] — per-query additive de-quantization shift.
    scale:  f32[(Q,)] — per-query multiplicative de-quantization scale.
    signed: bool — which quantization scheme produced this.
    """
    tables: torch.Tensor
    shift: torch.Tensor
    scale: torch.Tensor
    signed: bool

    @property
    def n_blocks(self):
        return self.tables.shape[1]


def block_dists_blocked(q_blocks, center_blocks):
    """q_blocks: (Q, B, dpb); center_blocks: (B, 16, dpb) -> (Q, B, 16).

    Expanded form ||q||^2 + ||c||^2 - 2 q.c, clamped at 0: cancellation
    can push it slightly negative when a query block sits on a center,
    and the bf16 fold encoding needs non-negative estimates to keep
    IEEE-bit order.
    """
    qn = torch.einsum("qbd,qbd->qb", q_blocks, q_blocks)
    cn = torch.einsum("bkd,bkd->bk", center_blocks, center_blocks)
    cross = torch.einsum("qbd,bkd->qbk", q_blocks, center_blocks)
    return torch.clamp(qn[:, :, None] + cn[None, :, :] - 2.0 * cross,
                       min=0.0)


def quantize_tables_signed(dists):
    """The 'signed' scheme: shift = mean * ln2 (about the median of the
    exponentially distributed squared distances), scale = 128 /
    (max * sqrt(n_blocks)), round half to even, clip to [-128, 127]."""
    B = dists.shape[1]
    sqrt_b = math.sqrt(B)
    shift = dists.mean(dim=(1, 2)) * LN2
    shifted = dists - shift[:, None, None]
    scale = 128.0 / (shifted.amax(dim=(1, 2)) * torch.tensor(
        sqrt_b, dtype=torch.float32))
    t = torch.round(shifted * scale[:, None, None])
    t = torch.clamp(t, -128, 127).to(torch.int8)
    return QuantizedTables(t, shift, scale, True)


def quantize_tables_unsigned(dists):
    """The 'unsigned' scheme: shift = min, scale = 255 / (max * ln(B) *
    sqrt(B)); true values in [0, 255], stored biased by -128."""
    B = dists.shape[1]
    sqrt_b = torch.tensor(math.sqrt(B), dtype=torch.float32)
    log_b = torch.tensor(math.log(max(B, 2)), dtype=torch.float32)
    shift = dists.amin(dim=(1, 2))
    shifted = dists - shift[:, None, None]
    scale = 255.0 / (shifted.amax(dim=(1, 2)) * log_b * sqrt_b)
    t = torch.round(shifted * scale[:, None, None])
    t = torch.clamp(t, 0, 255)
    t = (t - 128).to(torch.int8)
    return QuantizedTables(t, shift, scale, False)


def tables_bf16(dists):
    """Unquantized bf16 tables, identity shift and scale."""
    Q = dists.shape[0]
    return QuantizedTables(
        dists.to(torch.bfloat16),
        torch.zeros((Q,), dtype=torch.float32, device=dists.device),
        torch.ones((Q,), dtype=torch.float32, device=dists.device), True)


def dequantize_estimates(est, qt: QuantizedTables):
    """int32 (or f32) table sums -> approximate squared distances.

    Table entry b holds (||q_b - center_b||^2 - shift) * scale (stored
    minus 128 in the unsigned scheme), so a sum over the B blocks
    de-quantizes to est / scale + B * shift. Float tables have identity
    shift and scale."""
    B = qt.n_blocks
    est = est.to(torch.float32)
    if not qt.signed:
        est = est + 128.0 * B
    return est / qt.scale[..., None] + B * qt.shift[..., None]
