from .bruteforce import (
    bottom_k,
    bottom_k_2d,
    cdist,
    fp32_matmuls,
    knn_brute,
    knn_brute1,
    l2_normalize,
    sq_dists,
)
from .datasets import make_clustered, read_fvecs, truth_cache_path
from .grouping import (
    group_data_by_indices,
    invert_assignments,
    invert_assignments_csr,
    invert_assignments_csr_tiled,
)
from .padding import pad1, pad2, round_up
from .timing import block, enable_compilation_cache, profile_trace, timer

__all__ = [
    "bottom_k", "bottom_k_2d", "cdist", "fp32_matmuls", "knn_brute",
    "knn_brute1", "l2_normalize", "sq_dists", "make_clustered",
    "read_fvecs", "truth_cache_path", "group_data_by_indices",
    "invert_assignments", "invert_assignments_csr",
    "invert_assignments_csr_tiled", "pad1", "pad2", "round_up", "block",
    "enable_compilation_cache", "profile_trace", "timer",
]
