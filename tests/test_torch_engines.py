"""The 'xla' engine, ``pass1_method='approx'`` and ``tune_n_probes`` of
the port against the JAX package, on the CPU, on JAX-built indexes
served through an archive (tests/test_torch_serving.py's ``_pair``):
'xla' answers with the same sorted exact distances as the JAX package's
'xla' at rtol 1e-5, 'approx' selection gives the ids of 'exact', and
the tuner picks the same (n_probes, pass_1) as the JAX package's.
"""

import numpy as np
import pytest
import torch

from test_torch_serving import _assert_same_distances, _pair
from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu.models.ivf import tune_n_probes as jax_tune
from tinyknn_tpu_torch import IVF, knn_brute, load_ivf, make_clustered
from tinyknn_tpu_torch.models.ivf import TuneResult, tune_n_probes


# ------------------------------------------------- 'xla' and 'approx'


@pytest.mark.parametrize("metric, bp, table_dtype",
                         [("euclidean", 2, "int8"), ("angular", 1, "bf16"),
                          ("euclidean", 2, "f32")])
def test_xla_matches_jax(tmp_path, metric, bp, table_dtype):
    jax_ivf, port, qs = _pair(tmp_path, metric, bp, table_dtype,
                              scan_impl="xla", n_queries=80)
    assert port.scan_impl == "xla" and port._scan_engine() == "xla"
    for P in (1, 3):
        a, sa = jax_ivf.query(qs, k=10, n_probes=P, mode="bucket",
                              with_stats=True)
        b, sb = port.query(qs, k=10, n_probes=P, mode="bucket",
                           with_stats=True)
        assert sb == sa
        _assert_same_distances(jax_ivf, np.asarray(a), b.numpy(), qs)


def test_pass1_approx_equals_exact(tmp_path):
    """'approx' selects exactly on the card and here: the ids equal
    'exact''s; a JAX archive saved with 'approx' loads and serves."""
    X, qs = make_clustered(1200, 16, 80, seed=16)
    kw = dict(metric="euclidean", n_clusters=16, device="cpu")
    a = IVF(**kw, pass1_method="exact").fit(X).build(X, n_probes=2)
    b = IVF(**kw, pass1_method="approx").fit(X).build(X, n_probes=2)
    for P in (1, 4):
        torch.testing.assert_close(
            b.query(qs, k=10, n_probes=P, mode="bucket"),
            a.query(qs, k=10, n_probes=P, mode="bucket"))
    jax_ivf = JaxIVF("euclidean", 16, JaxFastPQ(2), scan_impl="xla",
                     pass1_method="approx")
    jax_ivf.fit(X).build(X, n_probes=2)
    save_ivf(tmp_path / "approx.npz", jax_ivf)
    port = load_ivf(tmp_path / "approx.npz", "cpu")
    assert port.pass1_method == "approx"
    assert tuple(port.query(qs, k=10, n_probes=2).shape) == (80, 10)


# ---------------------------------------------------------- tune_n_probes


@pytest.mark.parametrize("scan_impl, target", [("xla", 0.8),
                                               ("exact", 0.97)])
def test_tune_n_probes_matches_jax(tmp_path, scan_impl, target):
    rng = np.random.default_rng(17)
    X = rng.standard_normal((1500, 12)).astype(np.float32)
    qs = rng.standard_normal((30, 12)).astype(np.float32)
    trus = knn_brute(torch.as_tensor(qs), torch.as_tensor(X), 10).numpy()
    jax_ivf = JaxIVF("euclidean", 38, JaxFastPQ(2, rotate_dim=None),
                     scan_impl=scan_impl, pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=4 if scan_impl == "xla" else 1)
    save_ivf(tmp_path / "tune.npz", jax_ivf)
    port = load_ivf(tmp_path / "tune.npz", "cpu")
    want = jax_tune(jax_ivf, qs, trus, k=10, target_recall=target)
    got = tune_n_probes(port, qs, torch.as_tensor(trus), k=10,
                        target_recall=target)
    assert isinstance(got, TuneResult)
    assert (got.n_probes, got.pass_1) == (want.n_probes, want.pass_1)
    assert got.recall >= target and got.recalls[(got.n_probes,
                                                 got.pass_1)] == got.recall
    if scan_impl == "exact":   # the exact sliver: mult * k * P, mult >= 2
        assert got.pass_1 >= 2 * 10 * got.n_probes
    else:
        assert got.pass_1 >= 2 * ((got.n_probes + 1) * 10 + 1)
