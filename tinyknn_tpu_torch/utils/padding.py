"""Shape-padding helpers (counterpart of tinyknn_tpu/utils/padding.py).

The PQ code layout wants row and column counts that are multiples of
the block tiling. These helpers zero-pad NumPy arrays or torch tensors
and return the input's type and dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return x + (-x) % m


def pad1(arr, m: int):
    """Zero-pad a 1-D array so its length is a multiple of ``m``."""
    (s,) = arr.shape
    extra = (-s) % m
    if extra == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.nn.functional.pad(arr, (0, extra))
    return np.concatenate([arr, np.zeros((extra,), dtype=arr.dtype)])


def pad2(arr, m1: int, m2: int):
    """Zero-pad a 2-D array so shape[0] % m1 == 0 and shape[1] % m2 == 0."""
    s1, s2 = arr.shape
    e1, e2 = (-s1) % m1, (-s2) % m2
    if e1 == 0 and e2 == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.nn.functional.pad(arr, (0, e2, 0, e1))
    return np.pad(arr, ((0, e1), (0, e2)))
