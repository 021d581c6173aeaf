"""tinyknn_tpu_torch — the PyTorch/CUDA port of tinyknn_tpu.

4-bit product quantization + inverted-file search with exact rescore,
on PyTorch tensors, with the scans as hand-written CUDA kernels for
Hopper (``csrc/``: the IVF list scan over PQ codes, the exact engine's
list scan over bf16 vectors, the FastPQ full-scan estimate). Every
object keeps its state on the device it is given; CPU tensors run the
kernels' plain torch versions. Importing the package touches no GPU and
compiles nothing: a kernel is built with nvcc on its first launch.

Ported: FastPQ (fit, transform, tables, full-scan search), the
single-device IVF (fit, build, ``query`` in bucket and gather modes on
the 'fused', 'xla' and exact engines, ``rescore_rows``,
``query_stream``, ``tune_n_probes``), ``Flat``, reading and writing
the npz archives, the sharded indexes over a device mesh
(``tinyknn_tpu_torch.parallel``: ``ShardedIVF``, ``ShardedFastPQ``,
``lloyd_step_dp``; ``load_sharded_ivf``), the scan backends and the
saturating oracle (``ops.estimate_scan(backend=)``,
``estimate_scan_xla``, ``estimate_scan_saturating``,
``register_pallas_impl``), timing (``utils.timer``, ``block``,
``profile_trace``, ``enable_compilation_cache``), the dense inverted
lists (``utils.invert_assignments``), the .fvecs reader
(``utils.read_fvecs``), and the user examples
(``python -m tinyknn_tpu_torch.examples.<name>``).
"""

from . import ops, utils
from .io import (
    ivf_from_state,
    load_ivf,
    load_pq,
    load_sharded_ivf,
    pq_from_state,
    save_ivf,
    save_pq,
    sharded_ivf_from_state,
)
from .models import IVF, FastPQ, Flat, TransformedData
from .utils import (
    bottom_k,
    bottom_k_2d,
    cdist,
    group_data_by_indices,
    knn_brute,
    knn_brute1,
    make_clustered,
    pad1,
    pad2,
    truth_cache_path,
)

__version__ = "0.1.0"

__all__ = [
    "IVF", "FastPQ", "Flat", "TransformedData", "bottom_k", "bottom_k_2d",
    "cdist", "group_data_by_indices", "ivf_from_state", "knn_brute",
    "knn_brute1", "load_ivf", "load_pq", "load_sharded_ivf", "make_clustered",
    "pad1", "pad2", "pq_from_state", "save_ivf", "save_pq",
    "sharded_ivf_from_state", "truth_cache_path", "ops", "utils",
]
