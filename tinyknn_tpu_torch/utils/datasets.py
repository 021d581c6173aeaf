"""Benchmark datasets (counterpart of tinyknn_tpu/utils/datasets.py, and
of the .fvecs reader in tinyknn_tpu/native.py).

The recipe is copied from the JAX package unchanged, so both packages
draw byte-identical arrays from one seed and the checked-in ground
truth files grade either of them. tests/test_torch_layout.py pins the
two against each other.
"""

import numpy as np


def make_clustered(size, dim, n_queries, seed=10):
    """The `clustered-<size>-<dim>` dataset: sqrt(n)-component Gaussian
    mixture (sigma 0.5 around unit-Gaussian centers) — like the real
    embedding datasets, far from iid, so IVF probe-recall dynamics are
    comparable. Returns ``(data, queries)`` float32, split
    ``(size, dim)`` / ``(n_queries, dim)``.

    The rng call ORDER is part of the contract (centers, assignment,
    noise, in that order, one generator): do not reorder.
    """
    if n_queries <= 0:
        # data[:-0] would be empty: the split needs at least one query
        raise ValueError(f"n_queries must be positive, got {n_queries}")
    rng = np.random.default_rng(seed)
    n_comp = int((size + n_queries) ** 0.5)
    centers = rng.standard_normal((n_comp, dim), dtype=np.float32)
    which = rng.integers(0, n_comp, size + n_queries)
    data = centers[which] + 0.5 * rng.standard_normal(
        (size + n_queries, dim), dtype=np.float32)
    return data[:-n_queries], data[-n_queries:]


def truth_cache_path(size, dim, k, n_queries, metric, cache_dir=""):
    """Canonical ground-truth archive filename for a clustered dataset
    (shared by the sweep harness that writes it, the driver bench that
    gates on it, and the probes that load it)."""
    return (f"{cache_dir}trus_clustered-{size}-{dim}_k_neighbours={k}"
            f"_num_queries={n_queries}_metric='{metric}'.npy")


def read_fvecs(path):
    """Read an .fvecs file (each record an int32 dimension d, then d
    float32 values) to an (n, d) float32 array. Raises ValueError on an
    empty file, a dimension below 1, a size that is not a whole number
    of records, or records of unequal dimension."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        raise ValueError(f"empty .fvecs file: {path}")
    d = int(raw[0])
    if d < 1 or raw.size % (d + 1):
        raise ValueError(f"corrupt .fvecs file: {path}")
    recs = raw.reshape(-1, d + 1)
    if not np.all(recs[:, 0] == d):
        raise ValueError(f"ragged .fvecs file: {path}")
    return recs[:, 1:].view(np.float32).copy()
