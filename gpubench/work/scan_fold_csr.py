"""The PQ list scan of one batch (the job of K1, ``scan_fold_csr``).

The real blocks are those of the coded width (``code_dim``: FastPQ's
projection where it draws one, else the raw dimension). Bytes: the 4-bit
codes of the real blocks of every point of every list that any query
probes, read once; the int8 tables of every query, read once;
``pass_1`` int32 candidates out for each (query, probe) pair.
Operations: the one-hot products of the int8 tables, 2 x 16 per real
block, for every point of every probed list of every query.
"""

from . import peaks


def least_seconds(view):
    """``view``: ``counts`` (C,) list lengths, ``probes`` (Q, P) lists
    of each query, ``dim`` (raw) and ``code_dim`` (coded) widths,
    ``dims_per_block``, ``pass_1``."""
    blocks = -(-view.code_dim // view.dims_per_block)
    lens = view.counts[view.probes]
    probed = view.counts[view.probes.unique()].sum()
    Q, P = view.probes.shape
    moved = (int(probed) * -(-blocks // 2) + Q * 16 * blocks
             + Q * P * view.pass_1 * 4)
    ops = 2 * 16 * blocks * int(lens.sum())
    return peaks.least_seconds(moved, ops, "int8")
