"""Launches of the list-scan kernels (the program's own counters of K1
and K2) in the window, per closed-loop batch."""

KERNELS = ("scan_fold_csr", "scan_exact_csr")


def read(run):
    if run.kind != "closed_batch" or not run.calls:
        return None
    return sum(run.counters.get(k, 0) for k in KERNELS) / len(run.calls)
