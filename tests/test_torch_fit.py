"""The port's own fit and build, held to the JAX package by quality.

The port draws its k-means randomness from a ``torch.Generator``, so
its centers differ from the JAX package's; on the same data and
parameters its recall10@10 must come within 0.03 of the JAX index's.
"""

import numpy as np
import pytest
import torch

from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu_torch import IVF, FastPQ, knn_brute, make_clustered
from tinyknn_tpu_torch.ops.kmeans import blockwise_kmeans, kmeans_fit


def _recall(ids, truth):
    return np.mean([len(set(a.tolist()) & set(t.tolist())) / 10
                    for a, t in zip(ids, truth)])


@pytest.mark.parametrize("metric, build_probes, table_dtype",
                         [("angular", 1, "int8"), ("euclidean", 2, "bf16")])
def test_fit_recall_close_to_jax(metric, build_probes, table_dtype):
    X, qs = make_clustered(4000, 32, 100, seed=7)
    truth = knn_brute(torch.as_tensor(qs), torch.as_tensor(X), 10,
                      metric=metric).numpy()
    jax_ivf = JaxIVF(metric, 40, JaxFastPQ(2, table_dtype=table_dtype),
                     scan_impl="fused", pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=build_probes)
    port = IVF(metric, 40, FastPQ(2, table_dtype=table_dtype, device="cpu"),
               device="cpu")
    port.fit(X).build(X, n_probes=build_probes)
    assert port.build_probes == build_probes
    assert int(port.list_counts.sum()) == build_probes * len(X)
    for P in (1, 3):
        r_jax = _recall(np.asarray(jax_ivf.query(qs, 10, n_probes=P)), truth)
        r_port = _recall(port.query(qs, 10, n_probes=P).numpy(), truth)
        assert r_port >= r_jax - 0.03, (P, r_jax, r_port)


def test_fit_is_seeded():
    X, qs = make_clustered(1000, 16, 10, seed=3)
    a = IVF("euclidean", 10, FastPQ(2, seed=4, device="cpu"), seed=1,
            device="cpu").fit(X)
    b = IVF("euclidean", 10, FastPQ(2, seed=4, device="cpu"), seed=1,
            device="cpu").fit(X)
    assert torch.equal(a.all_centers, b.all_centers)
    assert torch.equal(a.pq.center_blocks, b.pq.center_blocks)


def test_kmeans_finds_separated_clusters():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((5, 8)).astype(np.float32) * 20
    X = torch.as_tensor(np.repeat(centers, 50, axis=0)
                        + rng.standard_normal((250, 8)).astype(np.float32))
    C, inertia = kmeans_fit(X, 5, generator=torch.Generator().manual_seed(0),
                            iters=10, chunk=64)
    err = torch.cdist(torch.as_tensor(centers), C).amin(dim=1)
    assert float(err.max()) < 1.0
    assert inertia / 250 < 2 * 8


def test_blockwise_kmeans_shapes_and_quality():
    gen = torch.Generator().manual_seed(0)
    cols = torch.randn(3, 500, 2, generator=gen)
    C = blockwise_kmeans(cols, generator=gen, k=16, iters=10, chunk=128)
    assert tuple(C.shape) == (3, 16, 2)
    # 16 centers leave much less error than the block's variance
    d2 = torch.cdist(cols, C).amin(dim=2) ** 2
    assert float(d2.mean()) < 0.25 * float(cols.var(dim=1).sum(-1).mean())


def test_transform_round_trip():
    X, _ = make_clustered(500, 20, 5, seed=9)
    pq = FastPQ(2, rotate_dim=None, device="cpu")
    data = pq.fit_transform(X)
    assert data.size == 500
    assert data.packed.dtype == torch.uint8
    assert tuple(data.codes.shape) == (504, 16)
    assert int(data.codes.max()) <= 15
