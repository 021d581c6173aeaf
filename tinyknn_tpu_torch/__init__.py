"""tinyknn_tpu_torch — the PyTorch/CUDA port of tinyknn_tpu.

4-bit product quantization + inverted-file search with exact rescore,
on PyTorch tensors, with the IVF list scan as a hand-written CUDA
kernel for Hopper (``csrc/scan_fold_csr.cu``). Every object keeps its
state on the device it is given; CPU tensors run the kernels' plain
torch versions. Importing the package touches no GPU and compiles
nothing: the kernel is built with nvcc on its first launch.

Ported so far: FastPQ fit/transform/tables and the IVF fit, build and
bucket-mode query (see ROADMAP.md for what remains).
"""

from .io import ivf_from_state, load_ivf
from .models import IVF, FastPQ, TransformedData
from .utils import knn_brute, make_clustered, truth_cache_path

__version__ = "0.1.0"

__all__ = [
    "IVF", "FastPQ", "TransformedData", "ivf_from_state", "knn_brute",
    "load_ivf", "make_clustered", "truth_cache_path",
]
