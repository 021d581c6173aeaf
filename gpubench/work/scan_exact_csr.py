"""The exact engine's list scan of one batch (the job of K2,
``scan_exact_csr``).

Bytes: the bf16 augmented vectors (the d coordinates, two norm terms
and a one) of every point of every list that any query probes, read
once; the bf16 augmented queries, read once; ``pass_1`` int32
candidates out for each (query, probe) pair. Operations: one
multiply-add per augmented entry for every point of every probed list
of every query, at the bf16 peak.
"""

from . import peaks


def least_seconds(view):
    """``view``: as for ``scan_fold_csr.least_seconds``."""
    d_aug = view.dim + 3
    lens = view.counts[view.probes]
    probed = view.counts[view.probes.unique()].sum()
    Q, P = view.probes.shape
    moved = (int(probed) * d_aug * 2 + Q * d_aug * 2
             + Q * P * view.pass_1 * 4)
    ops = 2 * d_aug * int(lens.sum())
    return peaks.least_seconds(moved, ops, "bf16")
