"""The kernels on the card against their plain torch versions.

Needs a CUDA device and nvcc; skipped elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card
machine need not have.)

K1 ``scan_fold_csr``: int8 tables and bf16 tables with integer values
must give bit-equal fold buffers; random bf16 tables agree within 1
bf16 ulp (the kernel and the plain version sum in the same order, so in
practice they are bit-equal too). K2 ``scan_exact_csr``: bit-equal on
integer-valued inputs, within 1 bf16 ulp (positions equal where the
values are) on random ones. K3 ``estimate_scan_tiled``: bit-equal for
int8 tables, rtol 1e-6 for bf16 and f32 tables.
"""

import pytest
import torch

from chip_smoke import (
    compare_estimates,
    compare_fold,
    estimate_case,
    estimate_inputs,
    exact_case,
    exact_inputs,
    fold_case,
    fold_inputs,
)
from tinyknn_tpu_torch.ops.kernels import (
    estimate_scan_tiled,
    estimate_scan_tiled_reference,
    scan_exact_csr,
    scan_exact_csr_reference,
    scan_fold_csr,
    scan_fold_csr_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B, qc", [(8, 20), (56, 32), (56, 40)])
@pytest.mark.parametrize("kind", ["int8", "bf16_int", "bf16"])
@pytest.mark.parametrize("W", [1, 2, 6])
def test_kernel_matches_plain(cuda, W, kind, B, qc):
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(W + B, kind, B=B, qc=qc), cuda)
    kw = dict(fold_tiles=W, max_tiles=max_tiles)
    launches = scan_fold_csr.launches
    got = scan_fold_csr(t, codes_tiled, toff, counts, **kw)
    want = scan_fold_csr_reference(t, codes_tiled, toff, counts, **kw)
    torch.cuda.synchronize()
    assert scan_fold_csr.launches == launches + 1
    compare_fold(got, want, kind != "int8", kind != "bf16",
                 t.shape[2] // 16, max_tiles)


def test_kernel_rejects_bad_input(cuda):
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(0, "int8"), cuda)
    with pytest.raises(ValueError):
        scan_fold_csr(t[:, :, :-16], codes_tiled, toff, counts,
                      fold_tiles=1, max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_fold_csr(t, codes_tiled, toff.cpu(), counts, fold_tiles=1,
                      max_tiles=max_tiles)


@pytest.mark.parametrize("d, qc", [(12, 20), (100, 40), (30, 8)])
@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("W", [1, 2, 6])
def test_exact_kernel_matches_plain(cuda, W, kind, d, qc):
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(W + d, kind, d=d, qc=qc), cuda)
    kw = dict(fold_tiles=W, max_tiles=max_tiles)
    launches = scan_exact_csr.launches
    got = scan_exact_csr(q_sel, vecs, toff, counts, **kw)
    want = scan_exact_csr_reference(q_sel, vecs, toff, counts, **kw)
    torch.cuda.synchronize()
    assert scan_exact_csr.launches == launches + 1
    compare_fold(got, want, True, kind == "int", 0, max_tiles)


def test_exact_kernel_rejects_bad_input(cuda):
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(0, "int"), cuda)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel[:, :, :-1], vecs, toff, counts, fold_tiles=1,
                       max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel, vecs, toff.cpu(), counts, fold_tiles=1,
                       max_tiles=max_tiles)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel[:, ::2], vecs, toff, counts, fold_tiles=1,
                       max_tiles=max_tiles)           # not contiguous


@pytest.mark.parametrize("n, B, Q", [(1000, 8, 20), (300, 56, 9),
                                     (5000, 64, 45)])
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_estimate_kernel_matches_plain(cuda, kind, n, B, Q):
    codes_tiled, t = estimate_inputs(*estimate_case(n + B, kind, n=n, B=B,
                                                    Q=Q), kind, cuda)
    launches = estimate_scan_tiled.launches
    got = estimate_scan_tiled(codes_tiled, t)
    want = estimate_scan_tiled_reference(codes_tiled, t)
    torch.cuda.synchronize()
    assert estimate_scan_tiled.launches == launches + 1
    compare_estimates(got, want, kind != "int8")


def test_estimate_kernel_rejects_bad_input(cuda):
    codes_tiled, t = estimate_inputs(*estimate_case(0, "int8"), "int8", cuda)
    with pytest.raises(ValueError):
        estimate_scan_tiled(codes_tiled, t[:, :7])
    with pytest.raises(ValueError):
        estimate_scan_tiled(codes_tiled.cpu(), t)
    with pytest.raises(TypeError):
        estimate_scan_tiled(codes_tiled, t.double())
