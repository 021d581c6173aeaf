from .bruteforce import fp32_matmuls, knn_brute, l2_normalize, sq_dists
from .datasets import make_clustered, truth_cache_path
from .grouping import invert_assignments_csr_tiled
from .padding import pad1, pad2, round_up

__all__ = [
    "fp32_matmuls", "knn_brute", "l2_normalize", "sq_dists",
    "make_clustered", "truth_cache_path", "invert_assignments_csr_tiled",
    "pad1", "pad2", "round_up",
]
