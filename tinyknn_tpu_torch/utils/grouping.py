"""Inverted-list construction (counterpart of tinyknn_tpu/utils/grouping.py).

Host-side NumPy: an index build computes this once. The layout is the
JAX package's lane-tiled CSR, bit for bit, so an index built by either
package serves from the other.
"""

from __future__ import annotations

import numpy as np


def invert_assignments_csr_tiled(assignments, n_lists: int,
                                 tile: int = 128, align_tiles: int = 1):
    """Lane-tiled CSR inverted lists for the ragged list scan.

    Each list's member ids are laid out contiguously and padded with -1
    to a multiple of ``tile``, so a list is a whole number of
    (tile,)-wide code tiles.

    Returns ``(flat_ids, tile_offsets, counts)``:
      flat_ids:     (N_pad,) int32, -1 padding; N_pad is a multiple of
                    ``tile`` (one extra all-padding guard tile is
                    appended so a trailing over-read stays in bounds).
      tile_offsets: (n_lists,) int32 — list i starts at flat index
                    ``tile_offsets[i] * tile``.
      counts:       (n_lists,) int32 true list lengths.

    Point i appears in lists ``assignments[i, :]`` (the build-probes
    spill), ordered within a list by (point, probe column).
    """
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    n, p = assignments.shape
    flat = assignments.reshape(-1).astype(np.int64)
    if n_lists <= 0:
        raise ValueError(f"n_lists must be positive, got {n_lists}")
    if flat.size and (flat.min() < 0 or flat.max() >= n_lists):
        raise ValueError("assignments out of range")
    counts = np.bincount(flat, minlength=n_lists).astype(np.int32)
    ntiles = -(-counts.astype(np.int64) // tile)
    if align_tiles > 1:  # lists start on multi-tile bounds
        ntiles = -(-ntiles // align_tiles) * align_tiles
    tile_offsets64 = np.zeros(n_lists, dtype=np.int64)
    np.cumsum(ntiles[:-1], out=tile_offsets64[1:])
    total = int(ntiles.sum()) + max(1, align_tiles)  # + guard tile(s)
    flat_ids = np.full(total * tile, -1, dtype=np.int32)

    order = np.argsort(flat, kind="stable")
    sorted_lists = flat[order]
    point_ids = (order // p).astype(np.int32)
    starts = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[sorted_lists]
    flat_ids[tile_offsets64[sorted_lists] * tile + pos] = point_ids
    return flat_ids, tile_offsets64.astype(np.int32), counts
