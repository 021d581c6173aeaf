"""K1's slot counts and real block count on the CPU, against the JAX
package's Pallas kernel in interpret mode, and the default device of
the port's entry points.

* ``slot_counts``: scan_fold_csr (on a CPU tensor, its plain version)
  equals the Pallas kernel on every occupied slot and holds the sentinel
  on every other, at 0, 1, 7, 8, 9 and all occupied slots, over skewed
  lists with an empty one and one whose last tile is ragged, for int8
  tables (bit-equal) and random bf16 tables (within 1 bf16 ulp, as XLA
  adds in another order);
* ``n_blocks``: the real block count below the padded one gives the
  full pad's fold bit for bit (the pad blocks' table rows are zero);
* the IVF query's ids do not move with the slot counts it passes;
* the entry points run on the card unless the caller asks for the CPU,
  and a machine without CUDA raises instead of falling back.
"""

import inspect

import numpy as np
import pytest
import torch

from chip_smoke import (
    SLOT_COUNT_CASES,
    compare_fold,
    fold_case,
    fold_inputs,
    slot_counts_for,
)
from test_torch_kernels import _jax_fold
from tinyknn_tpu_torch import IVF, FastPQ, Flat, make_clustered
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.ops.kernels import (
    ENC_INVALID,
    scan_fold_csr,
    scan_fold_csr_reference,
)
from tinyknn_tpu_torch.ops.topk import streaming_topk_init

QC = 20


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("s", SLOT_COUNT_CASES)
def test_slot_counts_match_jax_kernel(kind, s):
    case = fold_case(31, kind, B=8, qc=QC)
    want = _jax_fold(*case, 2)
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(*case, "cpu")
    assert int(counts[3]) == 0 and int(counts[0]) % 128   # empty; ragged
    got = scan_fold_csr(t, codes_tiled, toff, counts, fold_tiles=2,
                        max_tiles=max_tiles, n_blocks=8,
                        slot_counts=slot_counts_for(s, counts, QC))
    n = QC if s is None else s
    assert bool((got[:, n:] == ENC_INVALID).all())
    compare_fold(got[:, :n], torch.from_numpy(want[:, :n].copy()),
                 kind != "int8", kind == "int8", t.shape[2] // 16, max_tiles)


def test_mixed_slot_counts_match_jax_kernel():
    case = fold_case(32, "int8", B=8, qc=QC)
    want = torch.from_numpy(_jax_fold(*case, 1).copy())
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(*case, "cpu")
    sc = torch.tensor([QC, 9, 0, 3], dtype=torch.int32)
    got = scan_fold_csr(t, codes_tiled, toff, counts, fold_tiles=1,
                        max_tiles=max_tiles, slot_counts=sc)
    for c, n in enumerate(sc.tolist()):
        assert torch.equal(got[c, :n], want[c, :n])
        assert bool((got[c, n:] == ENC_INVALID).all())


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("B", [8, 50])
def test_n_blocks_matches_full_pad(kind, B):
    case = fold_case(7 + B, kind, B=B, qc=12)
    want = _jax_fold(*case, 2)
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(*case, "cpu")
    assert t.shape[2] // 16 > B                       # phantom pad blocks
    kw = dict(fold_tiles=2, max_tiles=max_tiles)
    full = scan_fold_csr_reference(t, codes_tiled, toff, counts, **kw)
    got = scan_fold_csr(t, codes_tiled, toff, counts, n_blocks=B, **kw)
    assert torch.equal(got, full)
    compare_fold(got, torch.from_numpy(want.copy()), kind != "int8",
                 kind == "int8", t.shape[2] // 16, max_tiles)


def test_new_arguments_are_checked():
    t, codes_tiled, toff, counts, max_tiles = fold_inputs(
        *fold_case(4, "int8"), "cpu")
    kw = dict(fold_tiles=1, max_tiles=max_tiles)
    for n_blocks in (0, t.shape[2] // 16 + 1):
        with pytest.raises(ValueError):
            scan_fold_csr(t, codes_tiled, toff, counts, n_blocks=n_blocks,
                          **kw)
    for sc in (counts.long(), counts[:2]):
        with pytest.raises(ValueError):
            scan_fold_csr(t, codes_tiled, toff, counts, slot_counts=sc, **kw)


def test_query_ids_do_not_move_with_slot_counts(monkeypatch):
    """The slot counts mark only slots that no pair reads: the ids are
    those of the scan over every slot."""
    X, qs = make_clustered(1500, 16, 96, seed=9)
    ivf = IVF("euclidean", 12, FastPQ(2, device="cpu"),
              device="cpu").fit(X).build(X, n_probes=2)
    seen = []

    def every_slot(*args, slot_counts=None, **kw):
        seen.append(slot_counts)
        return scan_fold_csr(*args, **kw)

    want = ivf.query(qs, k=10, n_probes=3, mode="bucket")
    monkeypatch.setattr(ivf_module, "scan_fold_csr", every_slot)
    got = ivf.query(qs, k=10, n_probes=3, mode="bucket")
    assert torch.equal(got, want)
    assert seen and all(s is not None and s.dtype == torch.int32
                        for s in seen)
    assert int(seen[0].sum()) == len(qs)              # round 0: one per query


def test_entry_points_default_to_the_card():
    for fn in (FastPQ.__init__, IVF.__init__, Flat.__init__,
               streaming_topk_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    ivf = IVF("euclidean", 4)
    assert ivf.device.type == ivf.pq.device.type == "cuda"
    assert FastPQ().device.type == Flat().device.type == "cuda"


def test_no_cpu_fallback():
    """Without CUDA the default device raises at the first allocation;
    with it, the index lives on the card."""
    X = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    if torch.cuda.is_available():
        assert IVF("euclidean", 4).fit(X).all_centers.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        IVF("euclidean", 4).fit(X)
    with pytest.raises((RuntimeError, AssertionError)):
        Flat().build(X)
    with pytest.raises((RuntimeError, AssertionError)):
        streaming_topk_init((2,), 3)
