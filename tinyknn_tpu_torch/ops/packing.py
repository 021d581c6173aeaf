"""4-bit code packing (counterpart of tinyknn_tpu/ops/packing.py).

    codes:  uint8[n, n_blocks], values 0..15      (compute format)
    packed: uint8[n, n_blocks // 2]               (storage format)

Two 4-bit codes per byte: the low nibble holds the even block, the
high nibble the odd block.
"""

from __future__ import annotations

import torch


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """uint8[..., B] (values 0..15) -> uint8[..., B/2]; B must be even."""
    if codes.shape[-1] % 2:
        raise ValueError("n_blocks must be even to nibble-pack")
    codes = codes.to(torch.uint8)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8[..., B/2] -> uint8[..., B] (values 0..15)."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
