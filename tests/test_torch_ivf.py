"""The slice as a whole: a JAX-built IVF served from the port.

A JAX ``IVF(scan_impl="fused", pass1_method="exact")`` is fitted and
built at a small size, saved with ``tinyknn_tpu.io.save_ivf`` and
loaded into the port with ``load_ivf``; both then answer the same
queries on the CPU (the JAX kernel in interpret mode, the port on its
plain fold). For every query the two id sets must have the same sorted
exact distances at rtol 1e-5, as tests/test_ivf.py compares the JAX
engines: that tolerates ties, which the two may order differently.
"""

import numpy as np
import pytest
import torch

from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu_torch import IVF, FastPQ, ivf_from_state, load_ivf
from tinyknn_tpu_torch.utils.datasets import make_clustered

CONFIGS = [("euclidean", 1, "int8", 800, 16, 8),
           ("angular", 2, "int8", 1500, 24, 12),
           ("euclidean", 2, "bf16", 2000, 32, 16),
           ("angular", 1, "bf16", 600, 16, 8)]


def _pair(tmp_path, metric, bp, table_dtype, n, d, C, seed=5):
    X, qs = make_clustered(n, d, 40, seed=seed)
    jax_ivf = JaxIVF(metric, C, JaxFastPQ(2, table_dtype=table_dtype),
                     scan_impl="fused", pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=bp)
    path = tmp_path / "index.npz"
    save_ivf(path, jax_ivf)
    return jax_ivf, load_ivf(path, "cpu"), qs


def _assert_same_distances(jax_ivf, a, b, qs):
    data = np.asarray(jax_ivf.data)
    if jax_ivf.metric == "angular":
        qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    a, b, qs = np.atleast_2d(a), np.atleast_2d(b), np.atleast_2d(qs)
    assert a.shape == b.shape
    for i in range(len(qs)):
        da = np.sort(((data[a[i]] - qs[i]) ** 2).sum(-1))
        db = np.sort(((data[b[i]] - qs[i]) ** 2).sum(-1))
        np.testing.assert_allclose(da, db, rtol=1e-5)


@pytest.mark.parametrize("metric, bp, table_dtype, n, d, C", CONFIGS)
def test_port_serves_jax_index(tmp_path, metric, bp, table_dtype, n, d, C):
    jax_ivf, port, qs = _pair(tmp_path, metric, bp, table_dtype, n, d, C)
    assert port.pq.table_dtype == table_dtype
    assert port.max_tiles == jax_ivf.max_tiles
    for P in (1, 3):
        a = np.asarray(jax_ivf.query(qs, k=10, n_probes=P, mode="bucket"))
        b = port.query(qs, k=10, n_probes=P)
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        _assert_same_distances(jax_ivf, a, b.numpy(), qs)


def test_skewed_batch_escalates_like_jax(tmp_path):
    """200 near-duplicate queries overflow round 0's 32-slot buckets:
    both packages retry at larger capacities and drop nothing."""
    jax_ivf, port, _ = _pair(tmp_path, "euclidean", 2, "int8", 2000, 16, 16)
    X = np.asarray(jax_ivf.data)
    rng = np.random.default_rng(0)
    qs = (X[5] + 0.01 * rng.standard_normal((200, 16))).astype(np.float32)
    a, sa = jax_ivf.query(qs, 10, n_probes=2, mode="bucket",
                          with_stats=True)
    b, sb = port.query(qs, 10, n_probes=2, with_stats=True)
    assert sb["dropped_probe_pairs"] == sa["dropped_probe_pairs"] == 0
    assert sb["queries_per_cluster_cap_round0"] > 32
    for key in ("queries_per_cluster_cap", "queries_per_cluster_cap_round0",
                "pass_1", "per_pair_candidates", "total_probe_pairs"):
        assert sb[key] == sa[key], key
    _assert_same_distances(jax_ivf, np.asarray(a), b.numpy(), qs)


def test_pinned_capacity_reports_drops(tmp_path):
    jax_ivf, port, _ = _pair(tmp_path, "euclidean", 1, "int8", 800, 16, 8)
    port.queries_per_cluster = 8
    qs = np.repeat(np.asarray(jax_ivf.data)[:1], 20, axis=0)
    _, stats = port.query(qs, 5, n_probes=1, with_stats=True)
    assert stats["dropped_probe_pairs"] == 12


def test_single_query(tmp_path):
    jax_ivf, port, qs = _pair(tmp_path, "angular", 2, "int8", 800, 16, 8)
    a = np.asarray(jax_ivf.query(qs[3], k=5, n_probes=2, mode="bucket"))
    b = port.query(qs[3], k=5, n_probes=2)
    assert tuple(b.shape) == (5,)
    _assert_same_distances(jax_ivf, a, b.numpy(), qs[3])


def test_labels_and_state_dict(tmp_path):
    X, qs = make_clustered(700, 16, 10, seed=2)
    labels = np.arange(700, dtype=np.int64) * 1000 + 7
    jax_ivf = JaxIVF("euclidean", 8, JaxFastPQ(2), scan_impl="fused",
                     pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=1, labels=labels)
    path = tmp_path / "index.npz"
    save_ivf(path, jax_ivf)
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    port = ivf_from_state(state, "cpu")
    got = port.query(qs, k=5)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ivf.query(qs, k=5,
                                                           mode="bucket")))
    with pytest.raises(ValueError):
        ivf_from_state({**state, "extra": np.zeros(1)}, "cpu")
    with pytest.raises(ValueError):
        ivf_from_state({**state, "format": np.int32(2)}, "cpu")


@pytest.mark.parametrize("kw, call", [
    (dict(scan_impl="xla"), None), (dict(scan_impl="exact"), None),
    (dict(pass1_method="approx"), None), (dict(rescore_rows=True), None),
    ({}, "gather")])
def test_unported_options_raise(kw, call):
    if call is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            IVF("euclidean", 4, **kw)
        return
    X, qs = make_clustered(300, 16, 4, seed=1)
    ivf = IVF("euclidean", 4, FastPQ(2)).fit(X).build(X, n_probes=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivf.query(qs, 5, mode=call)


def test_list_too_long_raises():
    X, qs = make_clustered(300, 16, 4, seed=1)
    ivf = IVF("euclidean", 4, FastPQ(2)).fit(X).build(X, n_probes=1)
    ivf.max_tiles = 1 << 14       # as if one list held 2,097,152 points
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivf.query(qs, 5)
