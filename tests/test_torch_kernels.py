"""scan_fold_csr's plain torch version against the JAX package's Pallas
kernel in interpret mode, on the CPU (the shapes of
tests/test_kernels.py: skewed lists with an empty one and one longer
than 128 points).

int8 tables and bf16 tables with integer values: bit-equal fold
buffers. Random bf16 tables: decoded values within 1 bf16 ulp, since
XLA sums the table entries in another order; positions equal wherever
the values are.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import compare_fold, fold_case, fold_inputs
from tinyknn_tpu.ops import kernels as jk
from tinyknn_tpu.ops.packing import pack_codes as j_pack
from tinyknn_tpu.utils.grouping import csr_scan_map
from tinyknn_tpu_torch.ops.kernels import (
    fold_encoding,
    scan_fold_csr,
    scan_fold_csr_reference,
)
from tinyknn_tpu_torch.utils.grouping import invert_assignments_csr_tiled


def _jax_fold(tables, codes, assign, W):
    C, qc, M = tables.shape
    flat_ids, toff, counts = invert_assignments_csr_tiled(assign, C)
    codes_tiled = np.asarray(jk.pack_codes_tiled(
        np.asarray(j_pack(codes)), flat_ids))
    t = jk.permute_tables_csr(jnp.asarray(tables), M // 16)
    if t.dtype != jnp.int8:
        t = t.astype(jnp.bfloat16)
    max_tiles = max(1, int(-(-counts.max() // 128)))
    smap = csr_scan_map(toff, counts, codes_tiled.shape[0])
    return np.asarray(jk.scan_fold_csr(
        t, codes_tiled, *smap, counts, fold_tiles=W, max_tiles=max_tiles,
        interpret=True))


@pytest.mark.parametrize("kind", ["int8", "bf16_int", "bf16"])
@pytest.mark.parametrize("W, B, qc", [(1, 8, 8), (2, 8, 20), (6, 8, 8),
                                      (2, 56, 16)])
def test_reference_matches_jax_kernel(kind, W, B, qc):
    case = fold_case(W + B + qc, kind, B=B, qc=qc)
    want = _jax_fold(*case, W)
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(*case, "cpu")
    got = scan_fold_csr_reference(t, codes_tiled, toff, counts,
                                  fold_tiles=W, max_tiles=max_tiles)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    compare_fold(got, torch.from_numpy(want.copy()), kind != "int8",
                 kind != "bf16", t.shape[2] // 16, max_tiles)


def test_wrapper_runs_plain_version_on_cpu():
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(1, "int8"), "cpu")
    launches = scan_fold_csr.launches
    got = scan_fold_csr(t, codes_tiled, toff, counts, fold_tiles=2,
                        max_tiles=max_tiles)
    want = scan_fold_csr_reference(t, codes_tiled, toff, counts,
                                   fold_tiles=2, max_tiles=max_tiles)
    assert torch.equal(got, want)
    assert scan_fold_csr.launches == launches  # no kernel ran


def test_empty_list_folds_to_sentinel():
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(2, "int8"), "cpu")
    assert int(counts[3]) == 0
    enc = scan_fold_csr(t, codes_tiled, toff, counts, fold_tiles=2,
                        max_tiles=max_tiles)
    assert bool((enc[3] == 2**31 - 1).all())


def test_fold_encoding_headroom():
    assert fold_encoding(torch.int8, 64, 26) == (12, 128 * 64)
    assert fold_encoding(torch.bfloat16, 64, 512) == (16, 0)
    with pytest.raises(ValueError):
        fold_encoding(torch.int8, 64, 1 << 11)    # (255*64+1) << 18 > 2^31
    with pytest.raises(ValueError):
        fold_encoding(torch.bfloat16, 64, 513)    # positions need > 16 bits
    with pytest.raises(TypeError):
        fold_encoding(torch.float32, 64, 1)


def test_wrapper_rejects_mismatched_inputs():
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(3, "int8"), "cpu")
    with pytest.raises(ValueError):
        scan_fold_csr(t[:, :, :-16], codes_tiled, toff, counts,
                      fold_tiles=1, max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_fold_csr(t, codes_tiled, toff.long(), counts, fold_tiles=1,
                      max_tiles=max_tiles)
