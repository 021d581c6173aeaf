"""The benchmark's span around IVF.fit (coarse k-means and the PQ
codebooks), ending in a sync."""


def read(run):
    return run.spans.get("fit")
