"""The corpus and its queries, made on the host from a seed.

``make_clustered`` is a frozen copy of the program's generator
(tinyknn_tpu_torch/utils/datasets.py), kept here so that no change to
the program can move the benchmark's data. The rng call order is part
of the recipe: centers, assignment, noise, one generator.
"""

import numpy as np


def make_clustered(size, dim, n_queries, seed=10):
    """The `clustered-<size>-<dim>` dataset: a sqrt(n)-component
    Gaussian mixture (sigma 0.5 around unit-Gaussian centers). Returns
    ``(data, queries)`` float32, ``(size, dim)`` and ``(n_queries,
    dim)``."""
    if n_queries <= 0:
        raise ValueError(f"n_queries must be positive, got {n_queries}")
    rng = np.random.default_rng(seed)
    n_comp = int((size + n_queries) ** 0.5)
    centers = rng.standard_normal((n_comp, dim), dtype=np.float32)
    which = rng.integers(0, n_comp, size + n_queries)
    data = centers[which] + 0.5 * rng.standard_normal(
        (size + n_queries, dim), dtype=np.float32)
    return data[:-n_queries], data[-n_queries:]
