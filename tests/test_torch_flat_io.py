"""``Flat``, the archives of ``io`` (both directions, every format), the
topk and utils helpers and the fixed Gaussian code of the port against
the JAX package, on the CPU.

Where the two packages answer the same queries, each query's id set must
have the same sorted exact distances at rtol 1e-5 (ties may be ordered
differently); arrays that only move through an archive, and the integer
outputs of the helpers, must be equal.
"""

import json

import numpy as np
import pytest
import torch

import tinyknn_tpu
import tinyknn_tpu_torch
from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu import Flat as JaxFlat
from tinyknn_tpu import io as jax_io
from tinyknn_tpu.ops import topk as jax_topk
from tinyknn_tpu.utils import bruteforce as jax_bf
from tinyknn_tpu.utils import grouping as jax_grouping
from tinyknn_tpu_torch import (
    IVF,
    FastPQ,
    Flat,
    load_ivf,
    load_pq,
    make_clustered,
    save_ivf,
    save_pq,
)
from tinyknn_tpu_torch.ops import topk
from tinyknn_tpu_torch.utils import bruteforce, grouping


def _sorted_d2(data, ids, qs, metric):
    ids, qs = np.atleast_2d(np.asarray(ids)), np.atleast_2d(qs)
    if metric == "angular":
        qs = qs / np.linalg.norm(qs, axis=-1, keepdims=True)
    return np.sort(((data[ids] - qs[:, None]) ** 2).sum(-1), axis=1)


def _same_distances(data, a, b, qs, metric):
    np.testing.assert_allclose(_sorted_d2(data, a, qs, metric),
                               _sorted_d2(data, b, qs, metric), rtol=1e-5)


# ------------------------------------------------------------------ Flat


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_flat_matches_jax(metric):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((700, 12)).astype(np.float32)
    qs = rng.standard_normal((25, 12)).astype(np.float32)
    a = np.asarray(JaxFlat(metric).fit(X).build(X).query(qs, k=10))
    port = Flat(metric, device="cpu").fit(X).build(X)
    b = port.query(qs, k=10)
    assert b.dtype == torch.int64 and tuple(b.shape) == (25, 10)
    data = port.data.numpy()
    _same_distances(data, a, b.numpy(), qs, metric)
    one = port.query(qs[4], k=6)
    assert tuple(one.shape) == (6,)
    _same_distances(data, np.asarray(JaxFlat(metric).build(X).query(
        qs[4], k=6)), one.numpy(), qs[4], metric)
    # k is capped at the corpus size, every row comes back once
    small = Flat(metric, device="cpu").build(X[:7])
    assert tuple(small.query(qs, k=10).shape) == (25, 7)
    assert sorted(small.query(qs[0], k=10).tolist()) == list(range(7))


def test_flat_needs_build_and_known_metric():
    with pytest.raises(RuntimeError, match="build"):
        Flat(device="cpu").query(np.zeros(4, np.float32), k=1)
    with pytest.raises(ValueError, match="metric"):
        Flat("cosine", device="cpu")


# -------------------------------------------------------------- archives

ARCHIVE_CONFIGS = [
    dict(metric="euclidean", bp=2, table_dtype="int8", labels=False),
    dict(metric="angular", bp=1, table_dtype="bf16", labels=True),
    dict(metric="angular", bp=2, table_dtype="int8", labels=False,
         scan_impl="exact", rescore_rows=True),
]


def _port_index(metric, bp, table_dtype, labels, scan_impl="fused",
                rescore_rows=False, n=1200, d=16, C=12):
    X, qs = make_clustered(n, d, 30, seed=8)
    lab = (np.arange(n, dtype=np.int64) * 5 + 1) << 34 if labels else None
    ivf = IVF(metric, C, FastPQ(2, table_dtype=table_dtype, device="cpu"),
              scan_impl=scan_impl, pass1_method="exact",
              rescore_rows=rescore_rows, fold_mult=6,
              scan_budget_bytes=1 << 29, device="cpu")
    ivf.fit(X).build(X, n_probes=bp, labels=lab)
    return ivf, qs


@pytest.mark.parametrize("cfg", ARCHIVE_CONFIGS,
                         ids=lambda c: f"{c['metric']}-{c['bp']}-"
                                       f"{c.get('scan_impl', 'fused')}")
def test_port_archive_serves_from_jax(tmp_path, cfg):
    """An index the port built and saved loads in tinyknn_tpu.io.load_ivf
    with the same arrays and options, and answers like the port."""
    port, qs = _port_index(**cfg)
    path = tmp_path / "port.npz"
    save_ivf(path, port)
    jax_ivf = jax_io.load_ivf(path)
    for key in ("metric", "n_clusters", "seed", "kmeans_iters",
                "queries_per_cluster", "pass1_method", "scan_impl",
                "build_probes", "fold_mult", "rescore_rows",
                "scan_budget_bytes", "max_tiles"):
        assert getattr(jax_ivf, key) == getattr(port, key), key
    for key in ("csr_codes", "csr_ids", "tile_offsets", "list_counts",
                "active_centers", "all_centers", "data"):
        np.testing.assert_array_equal(np.asarray(getattr(jax_ivf, key)),
                                      getattr(port, key).numpy())
    np.testing.assert_array_equal(np.asarray(jax_ivf.pq.center_blocks),
                                  port.pq.center_blocks.numpy())
    assert jax_ivf.pq.table_dtype == port.pq.table_dtype
    assert (jax_ivf.csr_raw is not None) == cfg.get("rescore_rows", False)
    a = np.asarray(jax_ivf.query(qs, k=8, n_probes=3, mode="bucket"))
    b = port.query(qs, k=8, n_probes=3, mode="bucket").numpy()
    if cfg["labels"]:        # labels back to rows: (row * 5 + 1) << 34
        assert np.isin(b, port.labels.numpy()).all()
        a, b = ((a >> 34) - 1) // 5, ((b >> 34) - 1) // 5
    _same_distances(port.data.numpy(), a, b, qs, cfg["metric"])


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cfg", ARCHIVE_CONFIGS,
                         ids=lambda c: f"{c['metric']}-{c['bp']}-"
                                       f"{c.get('scan_impl', 'fused')}")
def test_port_round_trip(tmp_path, cfg, compress):
    """port -> archive -> port: the same options, derived state rebuilt,
    identical ids in both modes."""
    port, qs = _port_index(**cfg)
    path = tmp_path / "rt.npz"
    save_ivf(path, port, compress=compress)
    back = load_ivf(path, "cpu")
    for key in ("metric", "n_clusters", "pass1_method", "scan_impl",
                "build_probes", "fold_mult", "rescore_rows",
                "scan_budget_bytes", "max_tiles"):
        assert getattr(back, key) == getattr(port, key), key
    assert (back.csr_vecs is None) == (port.csr_vecs is None)
    assert (back.csr_raw is None) == (port.csr_raw is None)
    for mode in ("bucket", "gather"):
        torch.testing.assert_close(
            back.query(qs, k=8, n_probes=3, mode=mode),
            port.query(qs, k=8, n_probes=3, mode=mode))


def test_save_unbuilt_raises(tmp_path):
    with pytest.raises(RuntimeError, match="not built"):
        save_ivf(tmp_path / "x.npz", IVF("euclidean", 4, device="cpu"))
    with pytest.raises(RuntimeError, match="not fitted"):
        save_pq(tmp_path / "x.npz", FastPQ(2, device="cpu"))


@pytest.mark.parametrize("rotate_dim, use_kmeans",
                         [(8, True), (None, True), (None, False)])
def test_pq_archive_both_ways(tmp_path, rotate_dim, use_kmeans):
    """save_pq -> load_pq in the port and in the JAX package: the same
    codebooks and rotation, the same codes and estimates."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    pq = FastPQ(2, rotate_dim=rotate_dim, use_kmeans=use_kmeans,
                kmeans_iters=9, table_dtype="bf16", device="cpu")
    data = pq.fit_transform(X)
    save_pq(tmp_path / "pq.npz", pq)
    back = load_pq(tmp_path / "pq.npz", "cpu")
    for key in ("dims_per_block", "use_kmeans", "rotate_dim", "seed",
                "backend", "kmeans_iters", "kmeans_n_init", "table_dtype"):
        assert getattr(back, key) == getattr(pq, key), key
    torch.testing.assert_close(back.transform(X).packed, data.packed)
    torch.testing.assert_close(
        back.distance_table(qs).estimate_distances(data),
        pq.distance_table(qs).estimate_distances(data))
    jax_pq = jax_io.load_pq(tmp_path / "pq.npz")
    np.testing.assert_array_equal(np.asarray(jax_pq.center_blocks),
                                  pq.center_blocks.numpy())
    assert (jax_pq.R is None) == (pq.R is None)
    if pq.R is not None:
        np.testing.assert_array_equal(np.asarray(jax_pq.R), pq.R.numpy())
    assert jax_pq.table_dtype == "bf16" and jax_pq.kmeans_iters == 9


def _jax_index(X, metric="euclidean", C=10, bp=2):
    ivf = JaxIVF(metric, C, JaxFastPQ(2), scan_impl="xla",
                 pass1_method="exact")
    return ivf.fit(X).build(X, n_probes=bp)


def _dense_grid(ivf, one_code_per_byte: bool):
    """tests/test_io.py's synthesis of a v1/v2 dense (C, cap) grid from
    a JAX CSR index: (list_codes, list_ids, counts)."""
    counts = np.asarray(ivf.list_counts)
    toff = np.asarray(ivf.tile_offsets)
    flat_ids = np.asarray(ivf.csr_ids)
    tiles = np.asarray(ivf.csr_codes)
    codes_rows = tiles.transpose(0, 2, 1).reshape(-1, tiles.shape[1])
    Bs = np.asarray(ivf.pq.center_blocks).shape[0] // 2
    C, cap = len(counts), max(8, int(-(-counts.max() // 8) * 8))
    list_codes = np.zeros((C, cap, Bs), np.uint8)
    list_ids = np.full((C, cap), -1, np.int32)
    for c in range(C):
        L, s = int(counts[c]), int(toff[c]) * 128
        list_codes[c, :L] = codes_rows[s:s + L, :Bs]
        list_ids[c, :L] = flat_ids[s:s + L]
    if one_code_per_byte:
        list_codes = np.stack([list_codes & 15, list_codes >> 4],
                              -1).reshape(C, cap, 2 * Bs)
    return list_codes, list_ids, counts.astype(np.int32)


@pytest.mark.parametrize("version, with_counts", [(2, True), (2, False),
                                                  (1, True)])
def test_dense_grid_archives(tmp_path, version, with_counts):
    """v1/v2 dense-grid archives (pre-v3 metadata: no build_probes) load
    into the CSR layout the JAX loader builds, with build_probes
    inferred from the lists, and answer like the JAX package."""
    rng = np.random.default_rng(10)
    X = rng.standard_normal((300, 12)).astype(np.float32)
    qs = rng.standard_normal((7, 12)).astype(np.float32)
    ivf = _jax_index(X)
    list_codes, list_ids, counts = _dense_grid(ivf, version == 1)
    extra = {"list_counts": counts} if with_counts else {}
    path = tmp_path / f"ivf_v{version}.npz"
    np.savez_compressed(
        path, format=np.int32(version), kind=np.frombuffer(b"ivf", np.uint8),
        ivf_meta=np.frombuffer(json.dumps({
            "metric": ivf.metric, "n_clusters": ivf.n_clusters,
            "seed": ivf.seed}).encode(), dtype=np.uint8),
        all_centers=np.asarray(ivf.all_centers),
        active_centers=np.asarray(ivf.active_centers),
        list_codes=list_codes, list_ids=list_ids,
        data=np.asarray(ivf.data), **extra, **jax_io._pq_state(ivf.pq))
    want = jax_io.load_ivf(path)
    port = load_ivf(path, "cpu")
    assert port.build_probes == want.build_probes == 2
    assert port.scan_impl == "auto" and port.max_tiles == want.max_tiles
    for key in ("csr_codes", "csr_ids", "tile_offsets", "list_counts"):
        np.testing.assert_array_equal(getattr(port, key).numpy(),
                                      np.asarray(getattr(want, key)))
    port.set_scan_impl("xla")
    _same_distances(np.asarray(ivf.data),
                    np.asarray(want.query(qs, k=5, n_probes=3,
                                          mode="bucket")),
                    port.query(qs, k=5, n_probes=3, mode="bucket").numpy(),
                    qs, "euclidean")


def test_unknown_format_rejected(tmp_path):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 8)).astype(np.float32)
    path = tmp_path / "v3.npz"
    jax_io.save_ivf(path, _jax_index(X, C=6))
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    state["format"] = np.int32(4)
    with pytest.raises(ValueError, match="v4"):
        tinyknn_tpu_torch.ivf_from_state(state, "cpu")


IVF_OPTIONAL_META = ("kmeans_iters", "queries_per_cluster", "pass1_method",
                     "scan_impl", "fold_mult", "rescore_rows",
                     "scan_budget_bytes", "build_probes")
PQ_OPTIONAL_META = ("kmeans_iters", "kmeans_n_init", "table_dtype")


@pytest.mark.parametrize("bp", [1, 2, 3])
def test_archive_without_optional_metadata(tmp_path, bp):
    """A v3 archive whose metadata lacks the fields the JAX loader reads
    with a default: the port takes the same defaults, infers
    build_probes as sum(list_counts) / n_rows as the JAX loader does,
    and answers like the JAX package (gather mode and the 'xla' engine,
    which both packages run alike)."""
    X, qs = make_clustered(900, 12, 20, seed=bp)
    jax_ivf = JaxIVF("angular", 9, JaxFastPQ(2, kmeans_iters=7,
                                            table_dtype="bf16"),
                     scan_impl="fused", fold_mult=4, rescore_rows=True)
    jax_ivf.fit(X).build(X, n_probes=bp)
    path = tmp_path / "full.npz"
    jax_io.save_ivf(path, jax_ivf)
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    for key, drop in (("ivf_meta", IVF_OPTIONAL_META),
                      ("pq_meta", PQ_OPTIONAL_META)):
        meta = json.loads(bytes(state[key]).decode())
        state[key] = np.frombuffer(json.dumps(
            {k: v for k, v in meta.items() if k not in drop}).encode(),
            dtype=np.uint8)
    path = tmp_path / "trimmed.npz"
    np.savez(path, **state)
    want = jax_io.load_ivf(path)
    port = load_ivf(path, "cpu")
    assert port.build_probes == want.build_probes == bp
    for key in IVF_OPTIONAL_META[:-1]:
        assert getattr(port, key) == getattr(want, key), key
    for key in PQ_OPTIONAL_META:
        assert getattr(port.pq, key) == getattr(want.pq, key), key
    assert port.pq.table_dtype == "int8" and port.csr_raw is None
    data = np.asarray(jax_ivf.data)
    for P in (1, 3):
        _same_distances(
            data, np.asarray(want.query(qs, k=6, n_probes=P, mode="gather")),
            port.query(qs, k=6, n_probes=P, mode="gather").numpy(), qs,
            "angular")
    port.set_scan_impl("xla")
    _same_distances(
        data, np.asarray(want.query(qs, k=6, n_probes=3, mode="bucket")),
        port.query(qs, k=6, n_probes=3, mode="bucket").numpy(), qs,
        "angular")


# --------------------------------------------------------------- helpers


def test_package_exports_match_jax():
    """Every name the JAX package exports at its top level (and from its
    utils) exists in the port, except the TPU timing tools."""
    for name in tinyknn_tpu.__all__:
        assert hasattr(tinyknn_tpu_torch, name), name
    port_utils = tinyknn_tpu_torch.utils
    for name in ("bottom_k", "bottom_k_2d", "cdist", "knn_brute",
                 "knn_brute1", "l2_normalize", "sq_dists",
                 "group_data_by_indices", "invert_assignments_csr"):
        assert name in port_utils.__all__, name
    for name in ("masked_smallest_k", "merge_topk", "streaming_topk_init"):
        assert name in tinyknn_tpu_torch.ops.__all__, name


def _tied(rng, shape, high=6):
    """Small integers as f32: many ties, to pin the tie order."""
    return rng.integers(0, high, size=shape).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5, 12])
def test_masked_smallest_k_matches_jax(k):
    rng = np.random.default_rng(k)
    vals = _tied(rng, (9, 12))
    mask = rng.random((9, 12)) < 0.6
    want_v, want_i = jax_topk.masked_smallest_k(vals, mask, k)
    got_v, got_i = topk.masked_smallest_k(torch.as_tensor(vals),
                                          torch.as_tensor(mask), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_streaming_merge_matches_jax():
    """streaming_topk_init + merge_topk over chunks: the same running
    state as the JAX package after every chunk, and the true k smallest
    at the end."""
    rng = np.random.default_rng(5)
    k, chunks = 7, [_tied(rng, (4, 9), high=20) for _ in range(5)]
    jv, ji = jax_topk.streaming_topk_init((4,), k)
    pv, pi = topk.streaming_topk_init((4,), k, device="cpu")
    assert pv.dtype == torch.float32 and pi.dtype == torch.int32
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    for n, c in enumerate(chunks):
        ids = (np.arange(9, dtype=np.int32) + 9 * n)[None].repeat(4, 0)
        jv, ji = jax_topk.merge_topk(jv, ji, c, ids)
        pv, pi = topk.merge_topk(pv, pi, torch.as_tensor(c),
                                 torch.as_tensor(ids))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        pv.numpy(), np.sort(np.concatenate(chunks, 1), 1)[:, :k])


def test_streaming_init_device_and_dtype():
    v, i = topk.streaming_topk_init((2, 3), 4, id_dtype=torch.int64,
                                    device="cpu")
    assert tuple(v.shape) == (2, 3, 4) and i.dtype == torch.int64
    assert torch.isinf(v).all() and (i == -1).all()


def test_cdist_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((40, 9)).astype(np.float32)
    Y = rng.standard_normal((30, 9)).astype(np.float32)
    got = bruteforce.cdist(X, Y, chunk=7, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (40, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bf.cdist(X, Y)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4, 10, 25])
def test_bottom_k_matches_jax(k):
    rng = np.random.default_rng(k)
    arr = _tied(rng, (10,))
    np.testing.assert_array_equal(
        bruteforce.bottom_k(torch.as_tensor(arr), k).numpy(),
        np.asarray(jax_bf.bottom_k(arr, k)))
    arr2 = _tied(rng, (6, 10))
    got = bruteforce.bottom_k_2d(torch.as_tensor(arr2), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_bf.bottom_k_2d(arr2, k)))


@pytest.mark.parametrize("k", [3, 50])
def test_knn_brute1_matches_jax(k):
    rng = np.random.default_rng(k)
    Y = rng.integers(-3, 4, size=(40, 5)).astype(np.float32)   # ties
    x = rng.integers(-3, 4, size=5).astype(np.float32)
    np.testing.assert_array_equal(
        bruteforce.knn_brute1(x, Y, k, device="cpu").numpy(),
        np.asarray(jax_bf.knn_brute1(x, Y, k)))


@pytest.mark.parametrize("n, c, k", [(50, 1, 6), (80, 3, 10), (5, 2, 9)])
def test_group_data_by_indices_matches_jax(n, c, k):
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    idx = rng.integers(0, k, size=(n, c))
    want_parts, want_ids = jax_grouping.group_data_by_indices(X, idx, k)
    parts, ids = grouping.group_data_by_indices(X, idx, k)
    assert len(parts) == len(ids) == k
    for a, b, ia, ib in zip(parts, want_parts, ids, want_ids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
    with pytest.raises(ValueError, match="range"):
        grouping.group_data_by_indices(X, idx + k, k)


@pytest.mark.parametrize("shape", [(60,), (60, 1), (45, 3)])
def test_invert_assignments_csr_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    assign = rng.integers(0, 11, size=shape)
    want = jax_grouping.invert_assignments_csr(assign, 12)
    got = grouping.invert_assignments_csr(assign, 12)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ use_kmeans=False


@pytest.mark.parametrize("rotate_dim", [None, 8])
def test_fixed_gaussian_code_matches_jax(rotate_dim):
    """The fixed ring code: the same centers as the JAX package (equal
    without rotation, rtol 1e-5 after the rotation, which the two
    packages multiply in different fp32 orders), and the same codes."""
    rng = np.random.default_rng(6)
    X = (rng.standard_normal((400, 16)) * rng.random(16) * 3).astype(
        np.float32)
    want = JaxFastPQ(2, use_kmeans=False, rotate_dim=rotate_dim).fit(X)
    got = FastPQ(2, use_kmeans=False, rotate_dim=rotate_dim,
                 device="cpu").fit(X)
    assert tuple(got.center_blocks.shape) == (8, 16, 2)
    if rotate_dim is None:
        np.testing.assert_array_equal(got.center_blocks.numpy(),
                                      np.asarray(want.center_blocks))
        np.testing.assert_array_equal(
            got.transform(X).codes.numpy(),
            np.asarray(want.transform(X).codes))
    else:
        np.testing.assert_allclose(got.center_blocks.numpy(),
                                   np.asarray(want.center_blocks),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.centers.numpy(),
                                  got.center_blocks.numpy().transpose(
                                      1, 0, 2).reshape(16, -1))


def test_fixed_gaussian_code_needs_two_dims_per_block():
    X = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="dims_per_block=2"):
        FastPQ(4, use_kmeans=False, rotate_dim=None, device="cpu").fit(X)
