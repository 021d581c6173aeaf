"""The sharded indexes of the port against the JAX package, on the CPU.

The JAX side is ``tinyknn_tpu.parallel`` on the 8 virtual CPU devices
(its Pallas kernels in interpret mode); the port runs a mesh that names
the CPU 8 times, on its kernels' plain versions. State crosses as numpy
arrays: a JAX ``ShardedIVF`` is fitted and built from a numpy seed,
written with ``tinyknn_tpu.io.save_ivf`` and placed by the port with
``sharded_ivf_from_state``.

Where the two packages answer the same queries, each query's ids must
have the same sorted exact distances at rtol 1e-5 (ties may be ordered
differently); where the port is held against itself (stream against
query, a re-sharded archive, ``set_scan_impl`` after placing) the ids
must be equal. Archives are in tests/test_torch_sharded_io.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chip_smoke import compare_fold
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu.models import fast_pq as jax_pq_module
from tinyknn_tpu.models import ivf as jax_ivf_module
from tinyknn_tpu.ops import kernels as jk
from tinyknn_tpu.parallel import ShardedFastPQ as JaxShardedFastPQ
from tinyknn_tpu.parallel import ShardedIVF as JaxShardedIVF
from tinyknn_tpu.parallel import lloyd_step_dp as jax_lloyd_step_dp
from tinyknn_tpu.parallel import make_mesh as jax_make_mesh
from tinyknn_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from tinyknn_tpu.parallel import sharded_ivf as jax_sharded_module
from tinyknn_tpu_torch import (
    IVF,
    FastPQ,
    knn_brute,
    load_ivf,
    make_clustered,
    pq_from_state,
    sharded_ivf_from_state,
)
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.parallel import (
    ShardedFastPQ,
    ShardedIVF,
    lloyd_step_dp,
    make_mesh,
    make_mesh_2d,
    replicate,
    shard_on_axis0,
)
from tinyknn_tpu_torch.parallel import sharded_ivf as sharded_module

CPU8 = ["cpu"] * 8


def _save(tmp_path, jax_index, name="index.npz"):
    save_ivf(tmp_path / name, jax_index)
    return tmp_path / name


def _state(path, jax_index):
    save_ivf(path, jax_index)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _pair(tmp_path, metric="euclidean", C=24, n=600, d=12, nq=16, bp=2,
          table_dtype="int8", scan_impl="fused", seed=3, n_dev=8, mesh=None,
          jax_mesh=None, query_axis=None, **kw):
    """(JAX ShardedIVF on the virtual CPU devices, the port's ShardedIVF
    placed from its arrays, data, queries)."""
    X, qs = make_clustered(n, d, nq, seed=seed)
    jax_sivf = JaxShardedIVF(
        metric, C, JaxFastPQ(2, seed=7, table_dtype=table_dtype),
        mesh=jax_mesh or jax_make_mesh(n_dev), query_axis=query_axis,
        seed=3, scan_impl=scan_impl, pass1_method="exact", **kw)
    jax_sivf.fit(X).build(X, n_probes=bp)
    port = sharded_ivf_from_state(
        _state(tmp_path / "index.npz", jax_sivf),
        mesh or make_mesh(devices=CPU8[:n_dev]), query_axis=query_axis)
    return jax_sivf, port, X, qs


def _sorted_d2(data, ids, qs, metric):
    if metric == "angular":
        qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    return np.sort(((data[ids] - qs[:, None]) ** 2).sum(-1), axis=1)


def _assert_same_distances(jax_index, a, b, qs):
    """Equal sorted exact distances at rtol 1e-5, and equal -1 slots."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a < 0, b < 0)
    data = np.asarray(jax_index.data)
    np.testing.assert_allclose(
        _sorted_d2(data, a, qs, jax_index.metric),
        _sorted_d2(data, b, qs, jax_index.metric), rtol=1e-5)


def _recall(ids, truth):
    return np.mean([len(set(a.tolist()) & set(t.tolist())) / len(t)
                    for a, t in zip(np.asarray(ids), np.asarray(truth))])


# ------------------------------------------------------------------ mesh


def test_mesh_helpers():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"shards": 8} and mesh.devices.size == 8
    assert make_mesh(3, devices=CPU8).devices.size == 3
    m2 = make_mesh_2d((2, 4), devices=CPU8)
    assert m2.shape == {"queries": 2, "shards": 4}
    assert m2.grid("shards", "queries")[1][2] == (1, 2)
    assert m2.grid("shards") == [[(0, 0), (0, 1), (0, 2), (0, 3)]]
    x = torch.arange(24.0).reshape(8, 3)
    placed = shard_on_axis0(m2, x, axis="shards")
    assert placed.shape == (8, 3)
    torch.testing.assert_close(placed[1, 2], x[4:6])
    # one copy per distinct (device, shard), not one per position
    assert placed[0, 2] is placed[1, 2]
    torch.testing.assert_close(torch.cat(placed.shards()), x)
    rep = replicate(m2, x)
    assert rep.shape == (8, 3) and rep[0, 0] is rep[1, 3]
    with pytest.raises(ValueError, match="need 9 devices"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="does not divide"):
        shard_on_axis0(mesh, torch.zeros(12, 2))


def test_mesh_needs_cuda_or_named_devices():
    """No CPU mesh is chosen silently on a machine without CUDA."""
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedIVF("euclidean", 4)


# ---------------------------------------------------- the sentinel list id


def _jax_tables(jax_ivf, qn, scan_impl):
    if scan_impl == "exact":
        return jax_ivf_module._augment_queries(jnp.asarray(qn)), None
    pq = jax_ivf.pq
    tables = jax_pq_module._build_tables(
        jnp.asarray(qn), pq.center_blocks, pq.R, pq.dims_per_block, True,
        pq.table_dtype).tables
    B = tables.shape[1]
    flat = tables.reshape(qn.shape[0], B * 16)
    return (jk.permute_tables_csr(flat, B) if scan_impl == "fused"
            else flat), B


@pytest.mark.parametrize("case", ["one_each", "more_sentinels_than_slots"])
@pytest.mark.parametrize("scan_impl", ["fused", "xla", "exact"])
def test_bucket_scan_round_sentinel(tmp_path, scan_impl, case):
    """A probe subset that holds the list count C as an id (the sharded
    index's 'another shard owns this pair'): like the JAX function, the
    port drops nothing, scans nothing for those pairs, and gives the
    real pairs the rows it gives them without the sentinels."""
    X, qs = make_clustered(500, 12, 9, seed=11)
    jax_ivf = JaxIVF("euclidean", 6, JaxFastPQ(2, seed=7),
                     scan_impl=scan_impl, pass1_method="exact", seed=3)
    jax_ivf.fit(X).build(X, n_probes=1)
    port = load_ivf(_save(tmp_path, jax_ivf), "cpu")
    C = port.tile_offsets.shape[0]
    if case == "one_each":
        probe_sub, qc = np.array([[0], [C], [C], [C], [1]]), 2
    else:
        probe_sub, qc = np.array([[2], [C], [C], [C], [C], [C], [2], [C],
                                  [0]]), 2
    Q = probe_sub.shape[0]
    real = probe_sub[:, 0] < C
    r, mult, max_tiles = 8, 8, port.max_tiles

    jt, _ = _jax_tables(jax_ivf, qs[:Q], scan_impl)
    want = jax_ivf_module._bucket_scan_round(
        jnp.asarray(probe_sub, jnp.int32), jt,
        jax_ivf.csr_vecs if scan_impl == "exact" else jax_ivf.csr_codes,
        jax_ivf.csr_ids, jax_ivf.tile_offsets, jax_ivf.list_counts,
        jax_ivf.scan_map, qc=qc, r=r, method="exact", scan_impl=scan_impl,
        max_tiles=max_tiles, fold_mult=mult)
    pt, B = ivf_module._scan_tables(
        torch.as_tensor(qs[:Q]), port.pq.center_blocks, port.pq.R, 2,
        port.pq.table_dtype, scan_impl)
    got = ivf_module._bucket_scan_round(
        torch.as_tensor(probe_sub), pt,
        port.csr_vecs if scan_impl == "exact" else port.csr_codes,
        port.tile_offsets, port.list_counts, qc=qc, r=r,
        max_tiles=max_tiles, fold_mult=mult, scan_impl=scan_impl, n_blocks=B)
    assert int(got[2]) == int(want[2]) == 0
    a, b = np.asarray(want[0])[real], got[0].numpy()[real]
    if scan_impl == "xla":
        np.testing.assert_allclose(b, a, rtol=1e-6)
        finite = np.isfinite(a)
        np.testing.assert_array_equal(got[1].numpy()[real][finite],
                                      np.asarray(want[1])[real][finite])
    else:
        # int8 tables: bit-equal; the exact engine: within 1 bf16 ulp,
        # positions equal where the values are (chip_smoke.compare_fold)
        compare_fold(torch.as_tensor(b), torch.as_tensor(a.copy()),
                     scan_impl == "exact", scan_impl == "fused",
                     pt.shape[1] // 16, max_tiles)
        np.testing.assert_array_equal(got[1].numpy()[real],
                                      np.asarray(want[1])[real])
    # and the same rows as a round without the sentinel pairs
    alone = ivf_module._bucket_scan_round(
        torch.as_tensor(probe_sub[real]), pt[torch.as_tensor(real)],
        port.csr_vecs if scan_impl == "exact" else port.csr_codes,
        port.tile_offsets, port.list_counts, qc=qc, r=r,
        max_tiles=max_tiles, fold_mult=mult, scan_impl=scan_impl, n_blocks=B)
    torch.testing.assert_close(got[0][torch.as_tensor(real)], alone[0])


# ----------------------------------------------------------------- _place


@pytest.mark.parametrize("n_dev, C, scan_impl, metric", [
    (8, 24, "fused", "euclidean"), (8, 22, "exact", "angular"),
    (3, 13, "exact", "euclidean"), (1, 12, "fused", "angular")])
def test_place_matches_jax(tmp_path, n_dev, C, scan_impl, metric):
    """Each shard's codes, ids, counts, raw vectors and exact tiles are
    the JAX stacked arrays cut by shard; offsets are equal for the real
    lists (a pad list's offset is 0 here, where JAX keeps a negative
    number that its clamping gathers never follow)."""
    jax_sivf, port, _, _ = _pair(tmp_path, metric, C, scan_impl=scan_impl,
                                 n_dev=n_dev)
    starts, stops, Cl, C_real = port._shard_meta
    j_starts, j_stops, j_Cl, j_C = jax_sivf._shard_meta
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_array_equal(stops, j_stops)
    assert (Cl, C_real, port._shard_tiles, port._n_active_real) == (
        j_Cl, j_C, jax_sivf._shard_tiles, jax_sivf._n_active_real)
    for name in ("csr_codes", "csr_ids", "list_counts", "list_vecs",
                 "tile_offsets"):
        want = np.asarray(getattr(jax_sivf, name))
        assert getattr(port, name).shape == want.shape, name
        want = want.reshape((n_dev, -1) + want.shape[1:])
        for s, got in enumerate(getattr(port, name).shards()):
            got = got.numpy()
            if name == "tile_offsets":
                real = np.arange(s * Cl, (s + 1) * Cl) < C_real
                np.testing.assert_array_equal(got[real], want[s][real])
                assert (got[~real] == 0).all()
            elif name == "csr_codes":
                # the guard tile's codes are never read (its ids are -1):
                # JAX keeps row 0's there, its archive writes zeros
                n_t = int(stops[s] - starts[s])
                np.testing.assert_array_equal(got[:n_t], want[s][:n_t])
            else:
                np.testing.assert_array_equal(got, want[s], err_msg=name)
    np.testing.assert_array_equal(port.active_centers.numpy(),
                                  np.asarray(jax_sivf.active_centers))
    if scan_impl == "exact":
        d = port.data.shape[1]
        want = np.asarray(jax_sivf.csr_vecs.astype(jnp.float32))
        want = want.reshape((n_dev, -1) + want.shape[1:])
        for s, got in enumerate(port.csr_vecs.shards()):
            got = got.float().numpy()
            np.testing.assert_array_equal(got[:, :d], want[s][:, :d])
            np.testing.assert_array_equal(got[:, d + 2:], want[s][:, d + 2:])
            # the norm rides as hi + lo: equal to 16 bits (f32 sums in
            # another order may split differently)
            np.testing.assert_allclose(got[:, d] + got[:, d + 1],
                                       want[s][:, d] + want[s][:, d + 1],
                                       rtol=2.0**-16)
    else:
        assert port.csr_vecs is None
    assert port.csr_raw is None


# ----------------------------------------------------------- the rank body


def _jax_rank_body(jax_sivf, qs, s, params, scan_impl):
    """The JAX ``_shard_local_query`` of shard ``s`` alone: run under a
    one-device shard_map on that shard's slices of the stacked arrays,
    with the centers rolled so that the shard's lists come first (so its
    axis index 0 owns them and the gather over one shard is the shard's
    own result). Returns (ids, d2, dropped) as numpy."""
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    n_dev = jax_sivf.mesh.shape[jax_sivf.axis]

    def cut(a):
        a = np.asarray(a)            # off the 8-device mesh, through numpy
        m = a.shape[0] // n_dev
        return jnp.asarray(a[s * m:(s + 1) * m])

    Cl = jax_sivf.tile_offsets.shape[0] // n_dev
    centers = jnp.asarray(np.roll(np.asarray(jax_sivf.active_centers),
                                  -s * Cl, axis=0))
    q = qs
    if jax_sivf.metric == "angular":
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    if scan_impl == "exact":
        tables = jax_ivf_module._augment_queries(jnp.asarray(q))
    else:
        tables = jax_sivf.pq._table(q, signed=True).qt.tables
    tables = jnp.asarray(np.asarray(tables))
    mesh1 = jax_make_mesh(1)
    step = functools.partial(
        jax_sharded_module._shard_local_query, axis="shards",
        psum_axes=("shards",), metric=jax_sivf.metric, k=k,
        n_probes=n_probes, pass_1=pass_1, r=r, r_tail=r_tail, qc=qc, qc0=qc0,
        method="exact", scan_impl=scan_impl, max_tiles=jax_sivf.max_tiles,
        build_probes=jax_sivf.build_probes, fold_mult=jax_sivf.fold_mult)
    spec = P("shards")
    out = jax.jit(jax.shard_map(
        step, mesh=mesh1,
        in_specs=(P(), P(), P(), spec, spec, spec, spec, (spec,) * 4, spec),
        out_specs=(P(), P(), P()), check_vma=False))(
        jnp.asarray(q), tables, centers,
        cut(jax_sivf.csr_vecs if scan_impl == "exact"
            else jax_sivf.csr_codes),
        cut(jax_sivf.csr_ids), cut(jax_sivf.tile_offsets),
        cut(jax_sivf.list_counts), tuple(cut(m) for m in jax_sivf.scan_map),
        cut(jax_sivf.list_vecs))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("metric, table_dtype, scan_impl, bp", [
    ("euclidean", "int8", "fused", 2), ("angular", "bf16", "fused", 1),
    ("euclidean", "int8", "xla", 2), ("angular", "int8", "exact", 2)])
def test_rank_body_matches_jax(tmp_path, metric, table_dtype, scan_impl, bp):
    """One shard's (ids, d2, dropped) before the merge, for the first,
    a middle and the last shard (which holds the pad lists): equal
    distances at atol 1e-5 and equal ids where a query's distances are
    distinct."""
    n_dev, C = 4, 22
    jax_sivf, port, _, qs = _pair(tmp_path, metric, C, bp=bp, nq=24,
                                  table_dtype=table_dtype,
                                  scan_impl=scan_impl, n_dev=n_dev)
    Cl = port._shard_meta[2]
    params = ivf_module._query_params(
        port, qs.shape[0], 6, 5, None, n_active=Cl,
        n_probes_max=port._n_active_real)
    assert params == jax_ivf_module._query_params(
        jax_sivf, qs.shape[0], 6, 5, None, n_active=Cl,
        n_probes_max=jax_sivf._n_active_real)
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    codes = port.csr_vecs if scan_impl == "exact" else port.csr_codes
    for s in (0, 1, n_dev - 1):
        want_ids, want_d2, want_drop = _jax_rank_body(jax_sivf, qs, s,
                                                      params, scan_impl)
        pos = (s,)
        ids, d2, drop = sharded_module._shard_local_query(
            torch.as_tensor(qs), port._centers[pos], port._pq_blocks[pos],
            None if port._pq_R is None else port._pq_R[pos], codes[pos],
            port.csr_ids[pos], port.tile_offsets[pos],
            port.list_counts[pos], port.list_vecs[pos], me=s, dpb=2,
            table_dtype=table_dtype, metric=metric, k=k, n_probes=n_probes,
            pass_1=pass_1, r=r, r_tail=r_tail, qc=qc, qc0=qc0,
            scan_impl=scan_impl, max_tiles=port.max_tiles,
            build_probes=port.build_probes, fold_mult=port.fold_mult)
        assert int(drop) == int(want_drop)
        ids, d2 = ids.numpy(), d2.numpy()
        assert ids.dtype == np.int32 and ids.shape == want_ids.shape
        np.testing.assert_array_equal(np.isfinite(d2), np.isfinite(want_d2))
        np.testing.assert_array_equal(ids < 0, ~np.isfinite(d2))
        fin = np.isfinite(d2)
        np.testing.assert_allclose(d2[fin], want_d2[fin], atol=1e-5)
        for i in range(ids.shape[0]):
            vals = want_d2[i][fin[i]]
            if len(vals) < 2 or np.diff(vals).min() > 1e-5:   # no near tie
                np.testing.assert_array_equal(ids[i], want_ids[i])


def test_one_shard_is_the_single_device_index(tmp_path):
    """One shard and no pad list: the ids of the single-device index
    with rescore_rows (the same scans, the same rescore by flat row)."""
    _, port, _, qs = _pair(tmp_path, "angular", 12, n_dev=1, nq=32)
    single = load_ivf(tmp_path / "index.npz", "cpu").set_rescore_rows(True)
    for P_ in (1, 3):
        torch.testing.assert_close(
            port.query(qs, k=7, n_probes=P_),
            single.query(qs, k=7, n_probes=P_, mode="bucket"))


def test_lloyd_step_dp_matches_jax_and_serial():
    rng = np.random.default_rng(10)
    n, d, k = 512, 8, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    C = X[:k].copy()
    C[k - 1] = 100.0        # an empty cluster keeps its center
    newC, inertia = lloyd_step_dp(X, C, make_mesh(devices=CPU8))
    want_C, want_i = jax_lloyd_step_dp(jnp.asarray(X), jnp.asarray(C),
                                       jax_make_mesh(8))
    np.testing.assert_allclose(newC.numpy(), np.asarray(want_C), atol=1e-5)
    np.testing.assert_allclose(float(inertia), float(want_i), rtol=1e-5)
    d2 = ((X[:, None] - C[None]) ** 2).sum(-1)
    assign = d2.argmin(1)
    expC = np.stack([X[assign == j].mean(0) if (assign == j).any() else C[j]
                     for j in range(k)])
    np.testing.assert_allclose(newC.numpy(), expC, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(inertia), d2.min(1).sum(), rtol=1e-4)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_fastpq_matches_jax(n_dev):
    """The point-sharded full scan: the JAX sharded search's distances
    (rtol 1e-5; its per-shard rescore depth and pad-row masks), valid
    rows only, and never worse than the single-device search."""
    n, d, nq, k = 333, 16, 12, 7
    X, qs = make_clustered(n, d, nq, seed=5)
    jax_spq = JaxShardedFastPQ(JaxFastPQ(2, seed=5),
                               mesh=jax_make_mesh(n_dev))
    jax_spq.fit(X).build(X)
    a = np.asarray(jax_spq.search(qs, k=k, method="exact"))
    from tinyknn_tpu.io import _pq_state
    state = dict(_pq_state(jax_spq.pq), format=np.int32(3),
                 kind=np.frombuffer(b"fastpq", np.uint8))
    pq = pq_from_state(state, "cpu")
    spq = ShardedFastPQ(pq, mesh=make_mesh(devices=CPU8[:n_dev])).build(X)
    np.testing.assert_array_equal(
        torch.cat(spq.codes.shards()).numpy(), np.asarray(jax_spq.codes))
    b = spq.search(qs, k=k)
    assert b.dtype == torch.int32 and tuple(b.shape) == (nq, k)
    b = b.numpy()
    assert ((b >= 0) & (b < n)).all()
    np.testing.assert_allclose(_sorted_d2(X, a, qs, "euclidean"),
                               _sorted_d2(X, b, qs, "euclidean"), rtol=1e-5)
    c = pq.search(qs, pq.transform(X), X, k=k).numpy()
    assert (_sorted_d2(X, b, qs, "euclidean")[:, -1]
            <= _sorted_d2(X, c, qs, "euclidean")[:, -1] + 1e-4).all()
    torch.testing.assert_close(spq.search(qs[2], k=k),
                               torch.as_tensor(b[2]))


def test_built_by_the_port_matches_placed_from_state():
    """fit + build on the port's own ShardedIVF places what
    ``sharded_ivf_from_state`` places from the same single-device state,
    labels included, and build() makes no single-device derived copy."""
    X, qs = make_clustered(700, 12, 20, seed=8)
    labels = np.arange(700, dtype=np.int64) * 1000 + 7
    mesh = make_mesh(devices=CPU8[:3])
    kw = dict(seed=2, scan_impl="exact", rescore_rows=True, device="cpu")
    sivf = ShardedIVF("angular", 10,
                      FastPQ(2, seed=5, rotate_dim=None, device="cpu"),
                      mesh=mesh, **kw).fit(X).build(X, 2, labels=labels)
    assert sivf.csr_raw is None and sivf.rescore_rows
    single = IVF("angular", 10,
                 FastPQ(2, seed=5, rotate_dim=None, device="cpu"),
                 **kw).fit(X).build(X, 2, labels=labels)
    got = sivf.query(qs, k=6, n_probes=3)
    assert got.dtype == torch.int64 and np.isin(got.numpy(), labels).all()
    want = single.query(qs, k=6, n_probes=3, mode="bucket")
    overlap = np.mean([len(set(x) & set(y)) / 6
                       for x, y in zip(got.tolist(), want.tolist())])
    assert overlap >= 0.9, overlap
    for name in ("csr_codes", "csr_ids", "tile_offsets", "list_counts"):
        assert getattr(sivf, name).shape[0] % 3 == 0
    with pytest.raises(RuntimeError, match="empty"):
        ShardedIVF("angular", 10, FastPQ(2, device="cpu"), mesh=mesh,
                   device="cpu").query(qs, k=3)
