"""The port's layouts and tables against the JAX package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages.
Layouts (dataset recipe, CSR lists, nibble packing, code tiles, table
permutation) must agree bit for bit; int8 tables may differ by 1 in at
most 0.1% of entries (f32 rounding at .5 boundaries), bf16 tables by
1 bf16 ulp, f32 tables by rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyknn_tpu.models.fast_pq import _build_tables as j_build_tables
from tinyknn_tpu.models.fast_pq import _encode as j_encode
from tinyknn_tpu.ops import kernels as jk
from tinyknn_tpu.ops.packing import pack_codes as j_pack
from tinyknn_tpu.ops.packing import unpack_codes as j_unpack
from tinyknn_tpu.ops.topk import dedup_candidates as j_dedup
from tinyknn_tpu.utils import datasets as jd
from tinyknn_tpu.utils import grouping as jg
from tinyknn_tpu.utils.bruteforce import knn_brute as j_knn
from tinyknn_tpu_torch.models.fast_pq import _build_tables, _encode
from tinyknn_tpu_torch.ops import kernels as tk
from tinyknn_tpu_torch.ops.packing import pack_codes, unpack_codes
from tinyknn_tpu_torch.ops.topk import dedup_candidates
from tinyknn_tpu_torch.utils import datasets as td
from tinyknn_tpu_torch.utils.bruteforce import knn_brute
from tinyknn_tpu_torch.utils.grouping import invert_assignments_csr_tiled
from tinyknn_tpu_torch.utils.padding import pad1, pad2


@pytest.mark.parametrize("size, dim, nq, seed",
                         [(1000, 16, 10, 10), (517, 100, 33, 3)])
def test_make_clustered_byte_identical(size, dim, nq, seed):
    for a, b in zip(jd.make_clustered(size, dim, nq, seed),
                    td.make_clustered(size, dim, nq, seed)):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    assert (td.truth_cache_path(5, 3, 10, 2, "angular")
            == jd.truth_cache_path(5, 3, 10, 2, "angular"))


def test_make_clustered_rejects_no_queries():
    with pytest.raises(ValueError):
        td.make_clustered(100, 4, 0)


@pytest.mark.parametrize("n, p, n_lists, align",
                         [(300, 1, 7, 1), (300, 2, 7, 1), (0, 1, 3, 1),
                          (500, 2, 12, 2)])
def test_invert_assignments_csr_tiled_bit_equal(n, p, n_lists, align):
    rng = np.random.default_rng(n + p)
    assign = rng.integers(0, n_lists, size=(n, p))
    want = jg.invert_assignments_csr_tiled(assign, n_lists,
                                           align_tiles=align,
                                           use_native=False)
    got = invert_assignments_csr_tiled(assign, n_lists, align_tiles=align)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert np.all(got[0][-128:] == -1)                 # guard tile


def test_invert_assignments_rejects_out_of_range():
    with pytest.raises(ValueError):
        invert_assignments_csr_tiled(np.array([[0], [5]]), 3)


@pytest.mark.parametrize("shape", [(10, 8), (3, 5, 56), (1, 2)])
def test_pack_unpack_bit_equal(shape):
    codes = np.random.default_rng(1).integers(0, 16, shape, dtype=np.uint8)
    packed = pack_codes(torch.as_tensor(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pack(codes)))
    np.testing.assert_array_equal(unpack_codes(packed).numpy(), codes)
    np.testing.assert_array_equal(
        unpack_codes(packed).numpy(), np.asarray(j_unpack(np.asarray(packed))))


@pytest.mark.parametrize("n, B", [(300, 8), (130, 56), (1, 4)])
def test_pack_codes_tiled_bit_equal(n, B):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 16, (n, B), dtype=np.uint8)
    flat_ids, _, _ = jg.invert_assignments_csr_tiled(
        rng.integers(0, 3, (n, 1)), 3, use_native=False)
    packed = np.asarray(j_pack(codes))
    want = np.asarray(jk.pack_codes_tiled(packed, flat_ids))
    got = tk.pack_codes_tiled(torch.from_numpy(packed.copy()),
                              torch.from_numpy(flat_ids))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B, dtype", [(8, np.int8), (56, np.int8),
                                      (16, np.float32), (50, np.float32)])
def test_permute_tables_csr_bit_equal(B, dtype):
    rng = np.random.default_rng(B)
    t = rng.integers(-128, 128, (3, 5, 16 * B)).astype(dtype)
    want = np.asarray(jk.permute_tables_csr(jnp.asarray(t), B))
    got = tk.permute_tables_csr(torch.as_tensor(t), B).numpy()
    assert got.shape[-1] == 32 * -(-(B // 2) // 8) * 8
    np.testing.assert_array_equal(got, want)


def test_padding():
    a = np.arange(5, dtype=np.float32)
    assert pad1(a, 4).shape == (8,)
    assert pad1(torch.as_tensor(a), 4).shape == (8,)
    m = np.ones((3, 5), np.int8)
    assert pad2(m, 8, 16).shape == (8, 16)
    assert pad2(torch.as_tensor(m), 8, 16).dtype == torch.int8
    assert pad2(m, 3, 5) is m


def _center_blocks(rng, B, dpb):
    return rng.standard_normal((B, 16, dpb)).astype(np.float32)


@pytest.mark.parametrize("d, dpb, rotate", [(16, 2, False), (100, 2, False),
                                            (24, 2, True), (32, 4, False)])
def test_codes_from_same_center_blocks_bit_equal(d, dpb, rotate):
    rng = np.random.default_rng(d)
    d_pad = -(-d // (8 * dpb)) * 8 * dpb
    B = d_pad // dpb
    cb = _center_blocks(rng, B, dpb)
    R = (np.linalg.qr(rng.standard_normal((d_pad, d_pad)))[0]
         .astype(np.float32) if rotate else None)
    X = np.zeros((200, d_pad), np.float32)
    X[:, :d] = rng.standard_normal((200, d))
    want = np.asarray(j_encode(jnp.asarray(X), jnp.asarray(cb),
                               None if R is None else jnp.asarray(R), dpb))
    got = _encode(torch.as_tensor(X), torch.as_tensor(cb),
                  None if R is None else torch.as_tensor(R), dpb).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table_dtype", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("d, rotate", [(100, False), (20, True)])
def test_tables_match_jax(table_dtype, d, rotate):
    rng = np.random.default_rng(7)
    dpb = 2
    d_pad = -(-d // 16) * 16
    B = d_pad // dpb
    cb = _center_blocks(rng, B, dpb)
    R = (np.linalg.qr(rng.standard_normal((d_pad, d_pad)))[0]
         .astype(np.float32) if rotate else None)
    q = rng.standard_normal((64, d)).astype(np.float32)
    want = np.asarray(j_build_tables(
        jnp.asarray(q), jnp.asarray(cb),
        None if R is None else jnp.asarray(R), dpb, True,
        table_dtype).tables.astype(jnp.float32))
    got = _build_tables(torch.as_tensor(q), torch.as_tensor(cb),
                        None if R is None else torch.as_tensor(R), dpb, True,
                        table_dtype).tables
    assert str(got.dtype).endswith({"int8": "int8", "bf16": "bfloat16",
                                    "f32": "float32"}[table_dtype])
    got = got.float().numpy()
    if table_dtype == "int8":
        diff = np.abs(got - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3
    elif table_dtype == "bf16":
        # the f32 distances may differ in their last bits (another
        # summation order in the rotation), which can move the bf16
        # rounding by one step: 1 bf16 ulp is at most 2^-7 relative
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_knn_brute_matches_jax(metric):
    X, q = td.make_clustered(3000, 24, 50, seed=4)
    want = np.asarray(j_knn(q, X, 10, metric=metric))
    got = knn_brute(torch.as_tensor(q), torch.as_tensor(X), 10,
                    metric=metric, chunk=16)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedup_candidates_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(-1, 6, (20, 12)).astype(np.int32)
    vals = rng.integers(0, 4, (20, 12)).astype(np.float32)
    want_ids, want_vals = (np.asarray(a) for a in j_dedup(ids, vals))
    got_ids, got_vals = dedup_candidates(torch.as_tensor(ids),
                                         torch.as_tensor(vals))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_vals.numpy(), want_vals)
