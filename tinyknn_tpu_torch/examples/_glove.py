"""The GloVe-shape clustered dataset that the tuning examples read
their archive against: its shape, the archive and truth file names that
``bench`` writes for it, and its queries (``make_clustered``'s, so the
checked-in truth grades them)."""

from __future__ import annotations

import os

from ..utils import make_clustered, truth_cache_path

SIZE, DIM, N_QUERIES = 1183514, 100, 10000
N_CLUSTERS = 1087
METRIC = "angular"


def index_name(build_probes: int = 1) -> str:
    """``bench``'s archive name for this dataset at dims_per_block=2."""
    return (f"ivf_clustered-{SIZE}-{DIM}_{METRIC}_num_clusters="
            f"{N_CLUSTERS}_dims_per_block=2_build_probes={build_probes}.npz")


def truth_file(cache_dir: str = ".") -> str:
    """``bench``'s ground-truth cache for this dataset (k=10)."""
    return truth_cache_path(SIZE, DIM, 10, N_QUERIES, METRIC,
                            cache_dir=os.path.join(cache_dir, ""))


def queries():
    return make_clustered(SIZE, DIM, N_QUERIES)[1]
