"""The single-device serving surface of the port against the JAX package,
on the CPU: ``query_stream`` (adaptive capacities, ``device_out``),
``rescore_rows`` and gather mode (the 'xla' engine, 'approx' selection
and ``tune_n_probes`` are in tests/test_torch_engines.py).

A JAX index is fitted and built at a small size, saved with
``tinyknn_tpu.io.save_ivf`` and loaded into the port with ``load_ivf``
(the JAX kernels in interpret mode, the port on its plain versions).
Where the two packages answer the same queries, each query's id set
must have the same sorted exact distances at rtol 1e-5 (ties may be
ordered differently); where the port is held against itself (stream
against query, rescore_rows on and off, 'approx' against 'exact') the
ids must be equal.
"""

import numpy as np
import pytest
import torch

from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu_torch import IVF, FastPQ, knn_brute, load_ivf, make_clustered
from tinyknn_tpu_torch.models import ivf as ivf_module


def _pair(tmp_path, metric="euclidean", bp=2, table_dtype="int8", n=1500,
          d=16, C=12, scan_impl="fused", n_queries=40, seed=5, **kw):
    X, qs = make_clustered(n, d, n_queries, seed=seed)
    jax_ivf = JaxIVF(metric, C, JaxFastPQ(2, table_dtype=table_dtype),
                     scan_impl=scan_impl, pass1_method="exact", **kw)
    jax_ivf.fit(X).build(X, n_probes=bp)
    path = tmp_path / "index.npz"
    save_ivf(path, jax_ivf)
    return jax_ivf, load_ivf(path, "cpu"), qs


def _sorted_d2(data, ids, qs, metric):
    ids, qs = np.atleast_2d(np.asarray(ids)), np.atleast_2d(qs)
    if metric == "angular":
        qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    return np.sort(((data[ids] - qs[:, None]) ** 2).sum(-1), axis=1)


def _assert_same_distances(jax_ivf, a, b, qs):
    data = np.asarray(jax_ivf.data)
    np.testing.assert_allclose(_sorted_d2(data, a, qs, jax_ivf.metric),
                               _sorted_d2(data, b, qs, jax_ivf.metric),
                               rtol=1e-5)


def _skewed_stream(X, rng, R, Q, row=13, sigma=0.02):
    return (X[row] + sigma * rng.standard_normal((R, Q, X.shape[1]))).astype(
        np.float32)


# ---------------------------------------------------------- query_stream

STREAM_CONFIGS = [("euclidean", 2, "int8", "fused"),
                  ("angular", 1, "bf16", "fused"),
                  ("euclidean", 2, "int8", "xla"),
                  ("angular", 2, "int8", "exact")]


@pytest.mark.parametrize("metric, bp, table_dtype, scan_impl",
                         STREAM_CONFIGS)
def test_stream_matches_jax_and_query(tmp_path, metric, bp, table_dtype,
                                      scan_impl):
    jax_ivf, port, qs = _pair(tmp_path, metric, bp, table_dtype,
                              scan_impl=scan_impl)
    stream = np.stack([qs, qs[::-1] + 1e-6])
    a, sa = jax_ivf.query_stream(stream, k=8, n_probes=3, with_stats=True)
    b, sb = port.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert b.dtype == torch.int32 and tuple(b.shape) == (2, 40, 8)
    assert sb == {**sa, "adaptive_qc_floors": tuple(
        sa["adaptive_qc_floors"])}
    assert port._stream_qc_floors == {
        key: tuple(v) for key, v in jax_ivf._stream_qc_floors.items()}
    for i in range(2):
        _assert_same_distances(jax_ivf, np.asarray(a)[i], b[i].numpy(),
                               stream[i])
        one, st = port.query(stream[i], k=8, n_probes=3, mode="bucket",
                             with_stats=True)
        assert st["dropped_probe_pairs"] == sb["dropped_probe_pairs"] == 0
        if scan_impl != "exact" or (
                st["queries_per_cluster_cap_round0"]
                == sb["queries_per_cluster_cap_round0"]
                and st["queries_per_cluster_cap"]
                == sb["queries_per_cluster_cap"]):
            # a PQ fold row depends on its own query only; exact fold
            # widths follow the capacities, so equal ids need equal ones
            torch.testing.assert_close(b[i], one)


def test_stream_device_out_and_labels():
    """device_out returns positional int32 ids and the dropped count as
    tensors on the index's device; the host path maps labels, and the
    labels of the positional ids are the host path's answer."""
    X, qs = make_clustered(600, 16, 64, seed=22)
    labels = (np.arange(600, dtype=np.int64) * 7 + 3) << 33
    ivf = IVF("angular", 10, FastPQ(2, device="cpu"), scan_impl="exact",
              rescore_rows=True, device="cpu")
    ivf.fit(X).build(X, n_probes=2, labels=labels)
    stream = qs.reshape(2, 32, 16)
    host = ivf.query_stream(stream, k=6, n_probes=3)
    assert host.dtype == torch.int64
    assert np.isin(host.numpy(), labels).all()
    out, dropped = ivf.query_stream(stream, k=6, n_probes=3,
                                    device_out=True)
    assert isinstance(out, torch.Tensor) and isinstance(dropped, torch.Tensor)
    assert out.dtype == torch.int32 and out.device == ivf.device
    assert int(dropped) == 0
    np.testing.assert_array_equal(labels[out.numpy()], host.numpy())
    with pytest.raises(ValueError, match="device_out"):
        ivf.query_stream(stream, k=6, n_probes=3, device_out=True,
                         with_stats=True)


def test_stream_adaptive_floors(tmp_path):
    """A skewed stream: the mean-load capacities drop pairs, the measured
    floors (the same as the JAX package measures) scan it drop-free, and
    each batch answers like query()'s escalated, drop-free batch."""
    jax_ivf, port, _ = _pair(tmp_path, "euclidean", 2, "int8", n=3000, C=24,
                             scan_impl="xla")
    port.set_scan_impl("fused")
    X = np.asarray(jax_ivf.data)
    stream = _skewed_stream(X, np.random.default_rng(31), 2, 64)
    _, raw = port.query_stream(stream, k=8, n_probes=3, with_stats=True,
                               adaptive_qc=False)
    _, jraw = jax_ivf.query_stream(stream, k=8, n_probes=3,
                                   with_stats=True, adaptive_qc=False)
    assert raw["dropped_probe_pairs"] == jraw["dropped_probe_pairs"] > 0
    assert raw["adaptive_qc_floors"] is None
    out, st = port.query_stream(stream, k=8, n_probes=3, with_stats=True)
    _, jst = jax_ivf.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] == 0
    assert st["adaptive_qc_floors"] == tuple(jst["adaptive_qc_floors"])
    assert port._stream_qc_floors[(64, 3)] == tuple(
        jax_ivf._stream_qc_floors[(64, 3)])
    for i in range(2):
        torch.testing.assert_close(
            out[i], port.query(stream[i], k=8, n_probes=3, mode="bucket"))


def test_stream_drift_remeasures(monkeypatch):
    """A stale cached floor drops pairs; the floor is measured again on
    the dropping stream, so the next same-shape stream is clean. Under a
    budget clamp the first call's own measurement is final: no further
    pre-pass runs, and the reported floors are the clamped ones."""
    X, _ = make_clustered(3000, 16, 8, seed=32)
    stream = _skewed_stream(X, np.random.default_rng(32), 1, 64)
    ivf = IVF("euclidean", 24, FastPQ(2, device="cpu"),
              device="cpu").fit(X).build(X, n_probes=2)
    ivf._stream_qc_floors = {(64, 3): (8, 8)}
    _, st1 = ivf.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st1["dropped_probe_pairs"] > 0
    assert ivf._stream_qc_floors[(64, 3)][0] > 8
    _, st2 = ivf.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st2["dropped_probe_pairs"] == 0

    calls = []
    real = ivf_module._stream_peak_loads
    monkeypatch.setattr(ivf_module, "_stream_peak_loads",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tight = IVF("euclidean", 24, FastPQ(2, device="cpu"),
                scan_budget_bytes=24 * 16 * 4 * 128, device="cpu")
    tight.fit(X).build(X, n_probes=2)
    _, st = tight.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] > 0 and len(calls) == 1
    _, st = tight.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] > 0 and len(calls) == 1
    assert st["adaptive_qc_floors"][1] <= st["queries_per_cluster_cap"]
    assert ((64, 3), tight.scan_budget_bytes) in tight._stream_floor_final
    tight.scan_budget_bytes = 2 << 30
    tight._stream_qc_floors = {}
    _, st = tight.query_stream(stream, k=8, n_probes=3, with_stats=True)
    assert st["dropped_probe_pairs"] == 0


@pytest.mark.parametrize("helper", ["query_params", "qc_caps",
                                    "stream_adaptive"])
@pytest.mark.parametrize("scan_impl", ["fused", "exact"])
def test_capacity_views_match_jax(tmp_path, helper, scan_impl):
    """The capacity helpers' sharded views (a local query count Q, a
    local list count n_active, a global probe clamp n_probes_max) give
    the JAX package's numbers, and differ from the unsharded defaults."""
    import jax.numpy as jnp
    from tinyknn_tpu.models import ivf as jax_ivf_module
    jax_ivf, port, _ = _pair(tmp_path, "euclidean", 2, "int8", n=3000, C=24,
                             scan_impl=scan_impl)
    mult = jax_ivf.fold_mult
    if helper == "query_params":
        args = (37, 8, 30, None)
        view = dict(qc_min=16, qc0_min=40, n_active=5, n_probes_max=7)
        got = ivf_module._query_params(port, *args, **view)
        assert got == jax_ivf_module._query_params(jax_ivf, *args, **view)
        assert got != ivf_module._query_params(port, *args, qc_min=16,
                                               qc0_min=40)
    elif helper == "qc_caps":
        for index in (jax_ivf, port):
            index.scan_budget_bytes = 4 * 5 * 128 * 40
        args = (300, 3, 40, 24, 8, 32)
        got = ivf_module._qc_caps(port, *args, n_active=5)
        assert got == jax_ivf_module._qc_caps(jax_ivf, *args, mult,
                                              n_active=5)
        assert got != ivf_module._qc_caps(port, *args)
    else:
        X = np.asarray(jax_ivf.data)
        stream = _skewed_stream(X, np.random.default_rng(33), 2, 64)
        view = dict(Q=16, n_active=5, n_probes_max=7)
        p_view = dict(n_active=5, n_probes_max=7)
        got = ivf_module._stream_adaptive_params(
            port, torch.as_tensor(stream), 8, 3, None,
            ivf_module._query_params(port, 16, 8, 3, None, **p_view), **view)
        want = jax_ivf_module._stream_adaptive_params(
            jax_ivf, jnp.asarray(stream), 8, 3, None,
            jax_ivf_module._query_params(jax_ivf, 16, 8, 3, None, **p_view),
            mult, **view)
        assert got[0] == tuple(want[0])
        assert got[1:] == (tuple(want[1]),) + tuple(want[2:])
        port._stream_qc_floors = {}
        assert got != ivf_module._stream_adaptive_params(
            port, torch.as_tensor(stream), 8, 3, None,
            ivf_module._query_params(port, 64, 8, 3, None))


def test_stream_exact_guard():
    X, _ = make_clustered(400, 8, 4, seed=13)
    ivf = IVF("euclidean", 8, FastPQ(2, device="cpu"),
              device="cpu").fit(X).build(X, n_probes=2)
    ivf.scan_impl = "exact"  # bypassing set_scan_impl on purpose
    with pytest.raises(RuntimeError, match="set_scan_impl"):
        ivf.query_stream(np.zeros((1, 4, 8), np.float32), k=3)


# ---------------------------------------------------------- rescore_rows


@pytest.mark.parametrize("bp", [1, 2])
@pytest.mark.parametrize("metric, scan_impl", [("euclidean", "fused"),
                                               ("angular", "fused"),
                                               ("angular", "exact"),
                                               ("euclidean", "exact")])
def test_rescore_rows_same_ids(tmp_path, metric, scan_impl, bp):
    """rescore_rows reads the rescore by flat row and decodes ids for the
    winners only: the ids must equal the default path's, with and
    without build-spill dedup, in query, in query_stream and through a
    save/load round trip."""
    from tinyknn_tpu_torch import save_ivf as port_save
    X, qs = make_clustered(900, 12, 32, seed=48)
    ivf = IVF(metric, 12,
              FastPQ(2, seed=5, rotate_dim=None, device="cpu"), seed=2,
              scan_impl=scan_impl, device="cpu").fit(X).build(X, n_probes=bp)
    want = ivf.query(qs, k=7, n_probes=4, mode="bucket")
    ivf.set_rescore_rows(True)
    assert ivf.csr_raw.shape == (ivf.csr_ids.shape[0], 12)
    got = ivf.query(qs, k=7, n_probes=4, mode="bucket")
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(
        ivf.query_stream(qs[None], k=7, n_probes=4)[0], want)
    path = tmp_path / "rr.npz"
    port_save(path, ivf)
    back = load_ivf(path, "cpu")
    assert back.rescore_rows and back.csr_raw is not None
    torch.testing.assert_close(back.query(qs, k=7, n_probes=4,
                                          mode="bucket"), want)
    ivf.set_rescore_rows(False)
    assert ivf.csr_raw is None


def test_jax_rescore_rows_archive(tmp_path):
    """A JAX index saved with rescore_rows=True serves from the port with
    the copy rebuilt, answering like the JAX index."""
    jax_ivf, port, qs = _pair(tmp_path, "angular", 2, "int8",
                              rescore_rows=True)
    assert port.rescore_rows and port.csr_raw is not None
    _assert_same_distances(
        jax_ivf, np.asarray(jax_ivf.query(qs, k=10, n_probes=3,
                                          mode="bucket")),
        port.query(qs, k=10, n_probes=3, mode="bucket").numpy(), qs)


# ----------------------------------------------------------- gather mode

GATHER_CONFIGS = [("euclidean", 2, "int8", "fused"),
                  ("angular", 1, "bf16", "fused"),
                  ("euclidean", 1, "f32", "xla"),
                  ("angular", 2, "int8", "exact")]


@pytest.mark.parametrize("metric, bp, table_dtype, scan_impl",
                         GATHER_CONFIGS)
def test_gather_matches_jax(tmp_path, metric, bp, table_dtype, scan_impl):
    jax_ivf, port, qs = _pair(tmp_path, metric, bp, table_dtype,
                              scan_impl=scan_impl, n_queries=16)
    for P in (1, 4):
        a, sa = jax_ivf.query(qs, k=10, n_probes=P, mode="auto",
                              with_stats=True)
        b, sb = port.query(qs, k=10, n_probes=P, with_stats=True)
        assert sb == sa and sb["mode"] == "gather"
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        _assert_same_distances(jax_ivf, np.asarray(a), b.numpy(), qs)
    one = port.query(qs[3], k=5, n_probes=2)
    assert tuple(one.shape) == (5,)
    _assert_same_distances(jax_ivf, np.asarray(
        jax_ivf.query(qs[3], k=5, n_probes=2)), one.numpy(), qs[3])


def test_auto_mode_threshold(tmp_path):
    _, port, qs = _pair(tmp_path, n_queries=40)
    assert port.query(qs[:32], 5, n_probes=2, with_stats=True)[1][
        "mode"] == "gather"                            # 64 pairs
    assert port.query(qs[:33], 5, n_probes=2, with_stats=True)[1][
        "mode"] == "bucket"                            # 66 pairs


def test_gather_labels():
    X, qs = make_clustered(900, 12, 25, seed=29)
    labels = 10**12 + 3 * np.arange(900, dtype=np.int64)
    plain = IVF("euclidean", 24, FastPQ(2, device="cpu"),
                device="cpu").fit(X).build(X, n_probes=2)
    tagged = IVF("euclidean", 24, FastPQ(2, device="cpu"),
                 device="cpu").fit(X).build(
        X, n_probes=2, labels=labels)
    for mode in ("bucket", "gather"):
        pos = plain.query(qs, k=7, n_probes=3, mode=mode).numpy()
        got = tagged.query(qs, k=7, n_probes=3, mode=mode)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), np.where(pos >= 0, labels[np.maximum(pos, 0)], -1))


def _jax_built(tmp_path, X, C, bp):
    """tests/test_ivf.py's index (the JAX package's CPU default engine,
    'xla'), served from the port."""
    jax_ivf = JaxIVF("euclidean", C, JaxFastPQ(2)).fit(X).build(
        X, n_probes=bp)
    save_ivf(tmp_path / "index.npz", jax_ivf)
    return load_ivf(tmp_path / "index.npz", "cpu")


@pytest.mark.parametrize("scan_impl", ["xla", "fused"])
def test_bucket_gather_parity(tmp_path, scan_impl):
    """tests/test_ivf.py's rule, on its index served from the port: gather
    rescores a superset of bucket's pass-1 cut, so its k-th distance is
    never worse, and the two overlap in at least 0.9 of their ids."""
    np.random.seed(12)
    X = np.random.randn(400, 16).astype(np.float32)
    qs = np.random.randn(10, 16).astype(np.float32)
    ivf = _jax_built(tmp_path, X, 20, 2).set_scan_impl(scan_impl)
    a = ivf.query(qs, k=5, n_probes=4, mode="bucket").numpy()
    b = ivf.query(qs, k=5, n_probes=4, mode="gather").numpy()
    for i in range(10):
        da = ((X[a[i]] - qs[i]) ** 2).sum(-1).max()
        db = ((X[b[i]] - qs[i]) ** 2).sum(-1).max()
        assert db <= da + 1e-4
    overlap = np.mean([len(set(a[i]) & set(b[i])) / 5 for i in range(10)])
    assert overlap >= 0.9, overlap


def test_bucket_vs_gather_recall_medium(tmp_path):
    """tests/test_ivf.py's rule, on its index served from the port: at
    P=12 the bucket path truncates tail pairs to r_tail < pass_1; its
    recall stays within 0.02 of gather's, on both PQ engines."""
    np.random.seed(14)
    X = np.random.randn(5000, 16).astype(np.float32)
    qs = np.random.randn(64, 16).astype(np.float32)
    trus = knn_brute(torch.as_tensor(qs), torch.as_tensor(X), 10).numpy()
    ivf = _jax_built(tmp_path, X, 70, 2)
    rec = {}
    for scan_impl in ("xla", "fused"):
        ivf.set_scan_impl(scan_impl)
        for mode in ("bucket", "gather"):
            g = ivf.query(qs, k=10, n_probes=12, mode=mode).numpy()
            rec[scan_impl, mode] = np.mean([len(set(a) & set(t)) / 10
                                            for a, t in zip(g, trus)])
        assert rec[scan_impl, "bucket"] >= rec[scan_impl, "gather"] - 0.02, rec
