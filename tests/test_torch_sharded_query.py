"""The query surface of the port's ``ShardedIVF`` against the JAX package,
on the CPU: the counterparts of the query cases of tests/test_sharded.py
(match single, recall, stats and skew, the 2-D mesh, stream == query,
``device_out``, exact mode, ``set_scan_impl`` after placing, the
adaptive floors and drift escalation). Set-up and tolerances are those
of tests/test_torch_sharded.py: the same sorted exact distances at
rtol 1e-5 against JAX, equal ids where the port is held against itself.
"""

import numpy as np
import pytest
import torch

from test_torch_sharded import (
    CPU8,
    _assert_same_distances,
    _pair,
    _recall,
    _sorted_d2,
)
from tinyknn_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from tinyknn_tpu_torch import knn_brute, load_ivf, sharded_ivf_from_state
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.parallel import make_mesh, make_mesh_2d


@pytest.mark.parametrize("metric, table_dtype, scan_impl", [
    ("euclidean", "int8", "fused"), ("angular", "bf16", "fused"),
    ("euclidean", "int8", "xla")])
def test_sharded_matches_jax_and_single(tmp_path, metric, table_dtype,
                                        scan_impl):
    """The port's sharded query answers like the JAX sharded query (same
    sorted distances, rtol 1e-5, same stats) and, like it, is never
    worse than the single-device index: per-shard rescore pools are a
    superset of the single-device pass-1 cut."""
    jax_sivf, port, X, qs = _pair(tmp_path, metric, 24,
                                  table_dtype=table_dtype,
                                  scan_impl=scan_impl)
    a, sa = jax_sivf.query(qs, k=8, n_probes=4, with_stats=True)
    b, sb = port.query(qs, k=8, n_probes=4, with_stats=True)
    assert b.dtype == torch.int32 and tuple(b.shape) == (16, 8)
    assert sb == sa
    _assert_same_distances(jax_sivf, a, b.numpy(), qs)
    single = load_ivf(tmp_path / "index.npz", "cpu")
    c = single.query(qs, k=8, n_probes=4, mode="bucket").numpy()
    data = np.asarray(jax_sivf.data)
    worst_b = _sorted_d2(data, b.numpy(), qs, metric)[:, -1]
    worst_c = _sorted_d2(data, c, qs, metric)[:, -1]
    assert (worst_b <= worst_c + 1e-4).all()
    overlap = np.mean([len(set(x) & set(y)) / 8
                       for x, y in zip(b.numpy().tolist(), c.tolist())])
    assert overlap >= 0.9, overlap
    one = port.query(qs[3], k=8, n_probes=4)
    torch.testing.assert_close(one, b[3])


def test_sharded_recall_matches_single(tmp_path):
    """tests/test_sharded.py's recall rule on the port: sharding cannot
    cost recall; and the port's recall is the JAX sharded index's."""
    jax_sivf, port, X, qs = _pair(tmp_path, "angular", 22, n=500, d=16,
                                  nq=20, bp=4)
    truth = knn_brute(torch.as_tensor(qs), torch.as_tensor(X), 10,
                      metric="angular").numpy()
    single = load_ivf(tmp_path / "index.npz", "cpu")
    r_single = _recall(single.query(qs, k=10, n_probes=10, mode="bucket"),
                       truth)
    r_port = _recall(port.query(qs, k=10, n_probes=10), truth)
    r_jax = _recall(jax_sivf.query(qs, k=10, n_probes=10), truth)
    assert r_port >= r_single - 1e-9 and r_single > 0.5
    assert abs(r_port - r_jax) < 1e-9


def test_sharded_query_stats_and_skew(tmp_path):
    """A near-duplicate batch overflows the per-shard buckets: the drops
    are summed over the shards and drive the same retries as in JAX."""
    jax_sivf, port, X, _ = _pair(tmp_path, "euclidean", 24, n=1200)
    rng = np.random.default_rng(2)
    qs = (X[3] + 0.02 * rng.standard_normal((300, 12))).astype(np.float32)
    a, sa = jax_sivf.query(qs, k=5, n_probes=3, with_stats=True)
    b, sb = port.query(qs, k=5, n_probes=3, with_stats=True)
    assert sb == sa
    assert sb["dropped_probe_pairs"] == 0
    assert sb["total_probe_pairs"] == 900
    assert sb["queries_per_cluster_cap_round0"] > ivf_module.default_qc0(
        300, 3)                                   # the retry ran
    _assert_same_distances(jax_sivf, a, b.numpy(), qs)
    port.queries_per_cluster = 8                  # pinned: no retry
    _, pinned = port.query(qs, k=5, n_probes=3, with_stats=True)
    jax_sivf.queries_per_cluster = 8
    _, jpinned = jax_sivf.query(qs, k=5, n_probes=3, with_stats=True)
    assert pinned["dropped_probe_pairs"] == jpinned[
        "dropped_probe_pairs"] > 0


def test_2d_mesh_matches_1d(tmp_path):
    """A queries x shards mesh answers like the JAX 2-D mesh, like the
    port's 1-D mesh of the same shards, and pads a batch that does not
    divide over the query rows."""
    kw = dict(C=16, n=800, nq=48, queries_per_cluster=64)
    jax_sivf, port, _, qs = _pair(
        tmp_path, "euclidean", jax_mesh=jax_make_mesh_2d((2, 4)),
        mesh=make_mesh_2d((2, 4), devices=CPU8), query_axis="queries", **kw)
    a = np.asarray(jax_sivf.query(qs, k=5, n_probes=4))
    b, stats = port.query(qs, k=5, n_probes=4, with_stats=True)
    assert tuple(b.shape) == (48, 5) and stats["total_probe_pairs"] == 192
    _assert_same_distances(jax_sivf, a, b.numpy(), qs)
    with np.load(tmp_path / "index.npz") as z:
        flat = sharded_ivf_from_state({key: z[key] for key in z.files},
                                      make_mesh(devices=CPU8[:4]))
    torch.testing.assert_close(flat.query(qs, k=5, n_probes=4), b)
    # one copy of a shard per distinct (device, shard)
    assert port.csr_codes[0, 2] is port.csr_codes[1, 2]
    torch.testing.assert_close(port.query(qs[:45], k=5, n_probes=4), b[:45])
    stream = port.query_stream(np.stack([qs, qs]), k=5, n_probes=4)
    torch.testing.assert_close(stream[1], b)
    with pytest.raises(ValueError, match="does not divide"):
        port.query_stream(qs[None, :45], k=5, n_probes=4)


@pytest.mark.parametrize("metric, scan_impl", [("angular", "fused"),
                                               ("euclidean", "xla")])
def test_sharded_query_stream_matches_query(tmp_path, metric, scan_impl):
    jax_sivf, port, _, _ = _pair(tmp_path, metric, 14, n=512, d=16,
                                 scan_impl=scan_impl,
                                 queries_per_cluster=64)
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((2, 48, 16)).astype(np.float32) * 3.0
    want = np.asarray(jax_sivf.query_stream(qs, k=6, n_probes=4))
    stream = port.query_stream(qs, k=6, n_probes=4)
    assert tuple(stream.shape) == (2, 48, 6) and stream.dtype == torch.int32
    for i in range(2):
        _assert_same_distances(jax_sivf, want[i], stream[i].numpy(), qs[i])
        torch.testing.assert_close(stream[i],
                                   port.query(qs[i], k=6, n_probes=4))


def test_sharded_query_stream_device_out(tmp_path):
    """device_out returns tensors (positional int32 ids and the dropped
    count), equal to the host path's and to JAX's device arrays."""
    jax_sivf, port, _, _ = _pair(tmp_path, "euclidean", 14, n=512, d=16,
                                 queries_per_cluster=64)
    rng = np.random.default_rng(4)
    qs = rng.standard_normal((2, 48, 16)).astype(np.float32)
    host = port.query_stream(qs, k=6, n_probes=4)
    out, dropped = port.query_stream(qs, k=6, n_probes=4, device_out=True)
    assert isinstance(out, torch.Tensor) and isinstance(dropped, torch.Tensor)
    assert out.dtype == torch.int32 and dropped.ndim == 0
    torch.testing.assert_close(out, host)
    want, want_dropped = jax_sivf.query_stream(qs, k=6, n_probes=4,
                                               device_out=True)
    assert int(dropped) == int(want_dropped) == 0
    for i in range(2):
        _assert_same_distances(jax_sivf, np.asarray(want)[i],
                               out[i].numpy(), qs[i])
    with pytest.raises(ValueError, match="device_out"):
        port.query_stream(qs, k=6, n_probes=4, device_out=True,
                          with_stats=True)


def test_sharded_exact_mode(tmp_path):
    """The sharded exact engine: true neighbours at full probe coverage,
    the JAX sharded answer at P=3, and a stream equal to query()."""
    jax_sivf, port, X, qs = _pair(tmp_path, "euclidean", 12,
                                  scan_impl="exact")
    truth = knn_brute(torch.as_tensor(qs), torch.as_tensor(X), 5).numpy()
    assert port.csr_vecs is not None
    assert _recall(port.query(qs, k=5, n_probes=12), truth) >= 0.99
    a, sa = jax_sivf.query(qs, k=5, n_probes=3, with_stats=True)
    b, sb = port.query(qs, k=5, n_probes=3, with_stats=True)
    assert sb == sa
    _assert_same_distances(jax_sivf, a, b.numpy(), qs)
    stream = port.query_stream(np.stack([qs, qs]), k=5, n_probes=3)
    torch.testing.assert_close(stream[0], b)
    torch.testing.assert_close(stream[1], b)


def test_sharded_set_scan_impl_after_place(tmp_path):
    """Switching a placed index to the exact engine derives the vector
    tiles per shard: the tiles and ids of an index placed as exact."""
    _, fresh, _, qs = _pair(tmp_path, "euclidean", 12, scan_impl="exact")
    with np.load(tmp_path / "index.npz") as z:
        state = {key: z[key] for key in z.files}
    meta = state["ivf_meta"].tobytes().replace(b'"scan_impl": "exact"',
                                               b'"scan_impl": "fused"')
    state["ivf_meta"] = np.frombuffer(meta, np.uint8)
    switched = sharded_ivf_from_state(state, make_mesh(devices=CPU8))
    assert switched.scan_impl == "fused" and switched.csr_vecs is None
    pq_ids = switched.query(qs, k=5, n_probes=3)
    switched.set_scan_impl("exact")
    for got, want in zip(switched.csr_vecs.shards(),
                         fresh.csr_vecs.shards()):
        assert torch.equal(got, want)
    torch.testing.assert_close(switched.query(qs, k=5, n_probes=3),
                               fresh.query(qs, k=5, n_probes=3))
    switched.set_scan_impl("auto")
    assert switched.csr_vecs is None
    torch.testing.assert_close(switched.query(qs, k=5, n_probes=3), pq_ids)
    switched.set_rescore_rows(True)
    assert switched.csr_raw is None and switched.rescore_rows
    with pytest.raises(ValueError, match="scan_impl"):
        switched.set_scan_impl("pallas")
    switched.scan_impl = "exact"      # bypassing set_scan_impl on purpose
    with pytest.raises(RuntimeError, match="set_scan_impl"):
        switched.query(qs, k=5)


def _skewed(X, seed, R, Q=64, row=13):
    rng = np.random.default_rng(seed)
    return (X[row] + 0.02 * rng.standard_normal((R, Q, X.shape[1]))).astype(
        np.float32)


def test_sharded_query_stream_adaptive_qc(tmp_path):
    """A skewed stream drops pairs under the mean-load capacities and
    none under the measured floors, which are the JAX package's; each
    batch then answers like query()'s escalated batch."""
    jax_sivf, port, X, _ = _pair(tmp_path, "euclidean", 24, n=3000, d=16)
    qs = _skewed(X, 41, 2)
    _, raw = port.query_stream(qs, k=8, n_probes=3, with_stats=True,
                               adaptive_qc=False)
    _, jraw = jax_sivf.query_stream(qs, k=8, n_probes=3, with_stats=True,
                                    adaptive_qc=False)
    assert raw == jraw and raw["dropped_probe_pairs"] > 0
    out, st = port.query_stream(qs, k=8, n_probes=3, with_stats=True)
    _, jst = jax_sivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st == {**jst, "adaptive_qc_floors": tuple(
        jst["adaptive_qc_floors"])}
    assert st["dropped_probe_pairs"] == 0
    assert port._stream_qc_floors == {
        key: tuple(v) for key, v in jax_sivf._stream_qc_floors.items()}
    assert (64, 3) in port._stream_qc_floors
    for i in range(2):
        torch.testing.assert_close(out[i],
                                   port.query(qs[i], k=8, n_probes=3))


def test_sharded_query_stream_adaptive_drift_escalation(tmp_path):
    """A stale cached floor: the stream reports the drops summed over the
    shards and measures the floor again, so the next one is clean."""
    jax_sivf, port, X, _ = _pair(tmp_path, "euclidean", 24, n=3000, d=16)
    qs = _skewed(X, 42, 1)
    for index in (port, jax_sivf):
        index._stream_qc_floors = {(64, 3): (8, 8)}
    _, st1 = port.query_stream(qs, k=8, n_probes=3, with_stats=True)
    _, jst1 = jax_sivf.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st1["dropped_probe_pairs"] == jst1["dropped_probe_pairs"] > 0
    assert port._stream_qc_floors[(64, 3)] == tuple(
        jax_sivf._stream_qc_floors[(64, 3)])
    assert port._stream_qc_floors[(64, 3)][0] > 8
    _, st2 = port.query_stream(qs, k=8, n_probes=3, with_stats=True)
    assert st2["dropped_probe_pairs"] == 0


