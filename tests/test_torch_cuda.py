"""scan_fold_csr on the card against its plain torch version.

Needs a CUDA device and nvcc; skipped elsewhere. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card
machine need not have.)

int8 tables and bf16 tables with integer values must give bit-equal
fold buffers; random bf16 tables agree within 1 bf16 ulp (the kernel
and the plain version sum in the same order, so in practice they are
bit-equal too).
"""

import pytest
import torch

from chip_smoke import compare_fold, fold_case, fold_inputs
from tinyknn_tpu_torch.ops.kernels import (
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
