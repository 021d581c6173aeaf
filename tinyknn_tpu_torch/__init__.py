"""tinyknn_tpu_torch — the PyTorch/CUDA port of tinyknn_tpu.

4-bit product quantization + inverted-file search with exact rescore,
on PyTorch tensors, with the scans as hand-written CUDA kernels for
Hopper (``csrc/``: the IVF list scan over PQ codes, the exact engine's
list scan over bf16 vectors, the FastPQ full-scan estimate). Every
object keeps its state on the device it is given; CPU tensors run the
kernels' plain torch versions. Importing the package touches no GPU and
compiles nothing: a kernel is built with nvcc on its first launch.

Ported so far: FastPQ fit/transform/tables/full-scan search and the IVF
fit, build and bucket-mode query with the PQ and exact engines (see
ROADMAP.md for what remains).
"""

from .io import ivf_from_state, load_ivf, load_pq, pq_from_state
from .models import IVF, FastPQ, TransformedData
from .utils import knn_brute, make_clustered, truth_cache_path

__version__ = "0.1.0"

__all__ = [
    "IVF", "FastPQ", "TransformedData", "ivf_from_state", "knn_brute",
    "load_ivf", "load_pq", "make_clustered", "pq_from_state",
    "truth_cache_path",
]
