"""Inverted-list construction (counterpart of tinyknn_tpu/utils/grouping.py).

Host-side NumPy: an index build computes this once. The layouts are the
JAX package's, bit for bit (the lane-tiled CSR, so an index built by
either package serves from the other, and the dense padded grid). The
JAX package can also build the dense grid and the tiled CSR in C++ (a
counting sort); that output equals these NumPy functions' bit for bit,
and the port's GloVe-shape index build takes well under a second
without it, so the port has no compiled counterpart.
"""

from __future__ import annotations

import numpy as np

from .padding import round_up


def invert_assignments(assignments, n_lists: int, pad_to: int = 8,
                       use_native: bool = True):
    """Padded inverted lists from an (N, p) assignment matrix.

    Point ``i`` appears in lists ``assignments[i, :]`` (the build-probes
    spill), in point order within a list. Returns ``(ids, counts)``:
    ``ids`` (n_lists, cap) int32 padded with -1, ``cap`` the longest
    list rounded up to a multiple of ``pad_to`` (at least ``pad_to``),
    and ``counts`` (n_lists,) int32. ``use_native`` is accepted for
    parity with the JAX package, which may build this in C++; the
    output is the same either way.
    """
    del use_native
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    p = assignments.shape[1]
    flat = assignments.reshape(-1).astype(np.int64)
    if n_lists <= 0:
        raise ValueError(f"n_lists must be positive, got {n_lists}")
    if flat.size and (flat.min() < 0 or flat.max() >= n_lists):
        raise ValueError("assignments out of range")
    counts = np.bincount(flat, minlength=n_lists).astype(np.int32)
    cap = max(round_up(int(counts.max()) if counts.size else 0, pad_to),
              pad_to)
    order = np.argsort(flat, kind="stable")
    sorted_lists = flat[order]
    starts = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[sorted_lists]
    ids = np.full((n_lists, cap), -1, dtype=np.int32)
    ids[sorted_lists, pos] = (order // p).astype(np.int32)
    return ids, counts


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


def invert_assignments_csr(assignments, n_lists: int):
    """CSR inverted lists without tiling: ``(flat_ids int32, offsets
    int64[n_lists + 1])``; list i holds flat_ids[offsets[i]:offsets[i+1]],
    ordered by (point, probe column)."""
    assignments = np.asarray(assignments)
    if assignments.ndim == 1:
        assignments = assignments[:, None]
    p = assignments.shape[1]
    flat = assignments.reshape(-1).astype(np.int64)
    counts = np.bincount(flat, minlength=n_lists).astype(np.int64)
    offsets = np.zeros(n_lists + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(flat, kind="stable")
    return (order // p).astype(np.int32), offsets


def group_data_by_indices(X, indices, k: int):
    """Group the rows of ``X`` (N, d) by ``indices`` (N, c) with values
    in [0, k): ``(parts, ids)``, k arrays of grouped rows and the
    matching row ids, rows within a group ordered by (probe column,
    row id)."""
    X = np.asarray(X)
    indices = np.asarray(indices)
    if indices.size and not (0 <= indices.min() and indices.max() < k):
        raise ValueError("indices out of range")
    n, _ = indices.shape
    # column-major flatten: probe column 0 of every point comes first
    flat = indices.T.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    point_ids = order % n
    bounds = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat, minlength=k), out=bounds[1:])
    parts, ids = [], []
    for g in range(k):
        sel = point_ids[bounds[g]:bounds[g + 1]]
        if sel.size == 0:
            parts.append(np.empty((0, X.shape[1])))
            ids.append(np.empty(0))
        else:
            parts.append(X[sel])
            ids.append(sel)
    return parts, ids
