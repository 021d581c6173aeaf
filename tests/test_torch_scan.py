"""The FastPQ full scan of the port against the JAX package, on the CPU.

* ``estimate_scan_tiled_reference`` against the JAX package's Pallas
  kernel in interpret mode, and the ``estimate_scan`` dispatcher against
  ``estimate_scan_xla``: int8 tables bit-equal; float tables at rtol
  1e-5 (XLA sums the blocks in another order);
* ``fold_topk_tiled`` against the JAX package's in interpret mode: the
  same estimates selected (the JAX version picks with approx_max_k over
  f32-rounded encodings, which may order equal estimates differently);
* the slice as a whole: a JAX FastPQ saved with ``save_pq`` and loaded
  with ``load_pq`` gives the same estimates and, for ``top`` and
  ``search`` (methods 'exact' and 'approx'), the same sorted exact
  distances at rtol 1e-5.
"""

from itertools import product

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (
    compare_estimates,
    estimate_case,
    estimate_inputs,
)
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf, save_pq
from tinyknn_tpu.ops import kernels as jk
from tinyknn_tpu.ops.quantization import QuantizedTables as JaxQT
from tinyknn_tpu.ops.quantization import dequantize_estimates as j_dequant
from tinyknn_tpu.ops.scan import estimate_scan_xla
from tinyknn_tpu_torch import FastPQ, load_pq, pq_from_state
from tinyknn_tpu_torch.models.fast_pq import _resolve_method, pass1_topk
from tinyknn_tpu_torch.ops import (
    QuantizedTables,
    dequantize_estimates,
    estimate_scan,
    estimate_scan_tiled,
    estimate_scan_tiled_reference,
    fold_topk_tiled,
    tile_codes,
)
from tinyknn_tpu_torch.ops.packing import pack_codes


@pytest.mark.parametrize("n, b, q", product([16, 200], [8, 56], [1, 9]))
def test_reference_matches_jax_kernel(n, b, q):
    codes, tables = estimate_case(n + b + q, "int8", n=n, B=b, Q=q)
    tiled = jk.tile_codes(np.asarray(pack_codes(torch.as_tensor(codes))))
    want = np.asarray(jk.estimate_scan_tiled(tiled, tables, interpret=True))
    codes_tiled, t = estimate_inputs(codes, tables, "int8", "cpu")
    np.testing.assert_array_equal(codes_tiled.numpy(), np.asarray(tiled))
    got = estimate_scan_tiled_reference(codes_tiled, t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("packed, n, b", [(False, 100, 8), (True, 100, 8),
                                          (True, 300, 56), (False, 40, 7)])
def test_dispatcher_matches_xla(kind, packed, n, b):
    codes, tables = estimate_case(n * b, kind, n=n, B=b, Q=5)
    jt = jnp.asarray(tables, jnp.bfloat16 if kind == "bf16" else None)
    want = np.asarray(estimate_scan_xla(codes, jt))
    t = torch.as_tensor(tables)
    if kind == "bf16":
        t = t.to(torch.bfloat16)
    c = torch.as_tensor(codes)
    got = estimate_scan(pack_codes(c) if packed else c, t, packed=packed)
    assert tuple(got.shape) == (5, n)
    if kind == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_dispatcher_rejects_unknown_backend():
    # backend is FastPQ's stored setting, kept for the JAX archives and
    # checked there; the dispatcher routes by device and takes none
    with pytest.raises(ValueError):
        FastPQ(backend="cuda", device="cpu")
    codes, tables = estimate_case(0, "int8", n=20)
    with pytest.raises(TypeError):
        estimate_scan(torch.as_tensor(codes), torch.as_tensor(tables),
                      backend="pallas")


def test_wrapper_runs_plain_version_on_cpu_and_checks_inputs():
    codes, tables = estimate_case(1, "f32", n=300)
    codes_tiled, t = estimate_inputs(codes, tables, "f32", "cpu")
    launches = estimate_scan_tiled.launches
    got = estimate_scan_tiled(codes_tiled, t)
    compare_estimates(got, estimate_scan_tiled_reference(codes_tiled, t),
                      True)
    assert estimate_scan_tiled.launches == launches   # no kernel ran
    with pytest.raises(ValueError):                   # odd block count
        estimate_scan_tiled(codes_tiled, t[:, :7])
    with pytest.raises(ValueError):                   # blocks vs tiles
        estimate_scan_tiled(codes_tiled, torch.cat([t, t, t[:, :2]], 1))
    with pytest.raises(TypeError):
        estimate_scan_tiled(codes_tiled, t.double())


def test_tile_codes_matches_jax():
    packed = np.random.default_rng(3).integers(0, 256, (300, 5),
                                               dtype=np.uint8)
    np.testing.assert_array_equal(
        tile_codes(torch.as_tensor(packed)).numpy(),
        np.asarray(jk.tile_codes(packed)))


@pytest.mark.parametrize("signed", [True, False])
def test_dequantize_matches_jax(signed):
    rng = np.random.default_rng(int(signed))
    est = rng.integers(-3000, 3000, (4, 50)).astype(np.int32)
    shift = rng.random(4).astype(np.float32)
    scale = (1 + rng.random(4)).astype(np.float32)
    tables = np.zeros((4, 24, 16), np.int8)
    want = np.asarray(j_dequant(jnp.asarray(est), JaxQT(
        jnp.asarray(tables), jnp.asarray(shift), jnp.asarray(scale),
        signed)))
    got = dequantize_estimates(torch.as_tensor(est), QuantizedTables(
        torch.as_tensor(tables), torch.as_tensor(shift),
        torch.as_tensor(scale), signed))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("n, rescore", [(1000, 30), (70, 40), (5000, 20)])
def test_fold_topk_matches_jax(n, rescore):
    codes, tables = estimate_case(n, "int8", n=n, B=16, Q=6)
    tiled = jk.tile_codes(np.asarray(pack_codes(torch.as_tensor(codes))))
    j_rows, j_valid = (np.asarray(a) for a in jk.fold_topk_tiled(
        tiled, jnp.asarray(tables), n, rescore, interpret=True))
    codes_tiled, t = estimate_inputs(codes, tables, "int8", "cpu")
    rows, valid = fold_topk_tiled(codes_tiled, t, n, rescore)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (6, rescore)
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    est = estimate_scan_tiled_reference(codes_tiled, t).numpy()
    for i in range(6):
        got = np.sort(est[i, rows[i].numpy()[valid[i].numpy()]])
        want = np.sort(est[i, j_rows[i][j_valid[i]]])
        np.testing.assert_array_equal(got, want)
        assert (rows[i].numpy()[valid[i].numpy()] < n).all()


def test_resolve_method_and_pass1():
    assert _resolve_method("auto") == "exact"
    assert _resolve_method("approx") == "approx"
    with pytest.raises(ValueError):
        _resolve_method("fast")
    vals = torch.tensor([[3, 1, 2, 1]])
    for method in ("exact", "approx"):
        v, i = pass1_topk(vals, 2, method)
        assert v.tolist() == [[1, 1]] and i.tolist() == [[1, 3]]


def _jax_pq(tmp_path, table_dtype, backend, n=2001, d=32, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((30, d)).astype(np.float32)
    jpq = JaxFastPQ(2, rotate_dim=None, backend=backend,
                    table_dtype=table_dtype)
    jdata = jpq.fit_transform(X)
    path = tmp_path / "pq.npz"
    save_pq(path, jpq)
    return jpq, jdata, load_pq(path, "cpu"), X, qs


def _same_distances(X, qs, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    da = np.sort(((X[a] - qs[:, None]) ** 2).sum(-1), axis=1)
    db = np.sort(((X[b] - qs[:, None]) ** 2).sum(-1), axis=1)
    np.testing.assert_allclose(db, da, rtol=1e-5)


@pytest.mark.parametrize("table_dtype, backend", [("int8", "pallas"),
                                                  ("bf16", "auto")])
def test_port_serves_jax_pq(tmp_path, table_dtype, backend):
    jpq, jdata, pq, X, qs = _jax_pq(tmp_path, table_dtype, backend)
    assert pq.backend == backend and pq.table_dtype == table_dtype
    data = pq.transform(X)
    assert data.size == jdata.size
    np.testing.assert_array_equal(data.packed.numpy(),
                                  np.asarray(jdata.packed))
    jdt, dt = jpq.distance_table(qs), pq.distance_table(qs)
    # the tables may round one entry to the neighbouring int8 (bf16)
    # value where f32 sums in another order straddle a rounding boundary
    jt, t = np.asarray(jdt.tables).astype(np.float32), dt.tables.float()
    assert (np.abs(t.numpy() - jt) > (1 if table_dtype == "int8"
                                      else 0.01 * np.abs(jt))).sum() == 0
    np.testing.assert_allclose(
        dt.estimate_distances(data, rescale=True).numpy(),
        np.asarray(jdt.estimate_distances(jdata, rescale=True)),
        rtol=1e-2, atol=0.05)
    _same_distances(X, qs, jdt.top(jdata, X, 10), dt.top(data, X, 10))
    for method in ("exact", "approx"):
        a = jpq.search(qs, jdata, X, k=10, method=method)
        b = pq.search(qs, data, X, k=10, method=method)
        assert b.dtype == torch.int32
        _same_distances(X, qs, a, b)
    one = pq.search(qs[3], data, X, k=5)
    assert tuple(one.shape) == (5,)
    _same_distances(X, qs[3:4], jpq.search(qs[3], jdata, X, k=5)[None],
                    one[None])


def test_pq_archive_checks(tmp_path):
    jpq, _, _, _, _ = _jax_pq(tmp_path, "int8", "auto", n=300, d=16)
    with np.load(tmp_path / "pq.npz") as z:
        state = {k: z[k] for k in z.files}
    pq = pq_from_state(state, "cpu")
    np.testing.assert_array_equal(pq.center_blocks.numpy(),
                                  np.asarray(jpq.center_blocks))
    with pytest.raises(ValueError):
        pq_from_state({**state, "extra": np.zeros(1)}, "cpu")
    with pytest.raises(ValueError):
        pq_from_state({**state, "kind": np.frombuffer(b"ivf", np.uint8)},
                      "cpu")


def test_ivf_archive_is_not_a_pq_archive(tmp_path):
    from tinyknn_tpu import IVF as JaxIVF
    X = np.random.default_rng(0).standard_normal((300, 16)).astype(
        np.float32)
    jax_ivf = JaxIVF("euclidean", 4, JaxFastPQ(2)).fit(X).build(X, 1)
    save_ivf(tmp_path / "ivf.npz", jax_ivf)
    with pytest.raises(ValueError):
        load_pq(tmp_path / "ivf.npz", "cpu")
