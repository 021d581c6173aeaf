"""The exact IVF engine of the port against the JAX package, on the CPU.

* the augmentation of points and queries: the x columns bit-equal, the
  two-term norm hi + lo within 2^-16 relative;
* ``scan_exact_csr_reference`` against the JAX package's Pallas kernel
  in interpret mode: bit-equal fold buffers on integer-valued inputs
  (every sum exact in f32), decoded values within 1 bf16 ulp and equal
  positions wherever the values are equal on random ones (XLA sums the
  dimensions in another order);
* ``slot_counts``: scan_exact_csr (on a CPU tensor, its plain version)
  equals the Pallas kernel on every occupied slot, by the same rules,
  and holds the sentinel on every other, at 0, 1, 7, 8, 9 and all
  occupied slots and at mixed per-list counts; bad counts are refused;
  the exact IVF query's ids do not move with the counts it passes;
* the slice as a whole: a JAX ``IVF(scan_impl="exact")`` saved with
  ``save_ivf`` and served from the port answers with the same sorted
  exact distances per query at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import (
    SLOT_COUNT_CASES,
    compare_fold,
    exact_case,
    exact_inputs,
    slot_counts_for,
)
from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu.models import ivf as jax_ivf_module
from tinyknn_tpu.ops import kernels as jk
from tinyknn_tpu.utils.grouping import csr_scan_map
from tinyknn_tpu_torch import IVF, FastPQ, load_ivf, make_clustered
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.models.ivf import (
    _aug_dim,
    _augment_data_csr,
    _augment_queries,
)
from tinyknn_tpu_torch.ops.kernels import (
    ENC_INVALID,
    scan_exact_csr,
    scan_exact_csr_reference,
)
from tinyknn_tpu_torch.utils.grouping import invert_assignments_csr_tiled


def _f32(a):
    return np.asarray(a).astype(np.float32)


def test_aug_dim():
    assert _aug_dim(100) == 112 == jax_ivf_module._aug_dim(100)
    assert _aug_dim(13) == 16 and _aug_dim(14) == 32


@pytest.mark.parametrize("d", [12, 100])
def test_augment_matches_jax(d):
    rng = np.random.default_rng(d)
    X = (3 * rng.standard_normal((700, d))).astype(np.float32)
    qs = rng.standard_normal((9, d)).astype(np.float32)
    assign = rng.integers(0, 5, (700, 1))
    flat_ids, _, _ = invert_assignments_csr_tiled(assign, 5)
    want = _f32(jax_ivf_module._augment_data_csr(jnp.asarray(X),
                                                 jnp.asarray(flat_ids)))
    got = _augment_data_csr(torch.as_tensor(X),
                            torch.as_tensor(flat_ids)).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :d], want[:, :d])
    np.testing.assert_array_equal(got[:, d + 2:], want[:, d + 2:])
    norm_got = got[:, d] + got[:, d + 1]
    norm_want = want[:, d] + want[:, d + 1]
    np.testing.assert_allclose(norm_got, norm_want, rtol=2.0**-16)

    want_q = _f32(jax_ivf_module._augment_queries(jnp.asarray(qs)))
    got_q = _augment_queries(torch.as_tensor(qs)).float().numpy()
    np.testing.assert_array_equal(got_q[:, :d + 2], want_q[:, :d + 2])
    np.testing.assert_array_equal(got_q[:, d + 3:], want_q[:, d + 3:])
    # |q|^2 rides in one bf16 slot: f32 sums in another order may round
    # to the neighbouring bf16 value
    np.testing.assert_allclose(got_q[:, d + 2], want_q[:, d + 2],
                               rtol=2.0**-8)


def _jax_exact(q_aug, x_aug, assign, W):
    C = q_aug.shape[0]
    flat_ids, toff, counts = invert_assignments_csr_tiled(assign, C)
    vecs = x_aug[np.maximum(flat_ids, 0)].reshape(-1, 128, x_aug.shape[1])
    vecs = jnp.asarray(vecs.transpose(0, 2, 1), jnp.bfloat16)
    max_tiles = max(1, int(-(-counts.max() // 128)))
    smap = csr_scan_map(toff, counts, vecs.shape[0])
    return np.asarray(jk.scan_exact_csr(
        jnp.asarray(q_aug, jnp.bfloat16), vecs, *smap, counts,
        fold_tiles=W, max_tiles=max_tiles, interpret=True))


@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("W, d, qc", [(1, 12, 8), (2, 12, 20), (6, 30, 8)])
def test_reference_matches_jax_kernel(kind, W, d, qc):
    case = exact_case(W + d + qc, kind, d=d, qc=qc)
    want = _jax_exact(*case, W)
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(*case, "cpu")
    got = scan_exact_csr_reference(q_sel, vecs, toff, counts, fold_tiles=W,
                                   max_tiles=max_tiles)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert bool((got[3] == 2**31 - 1).all())          # the empty list
    compare_fold(got, torch.from_numpy(want.copy()), True, kind == "int",
                 0, max_tiles)


def test_near_tie_rule_of_the_fold_comparison():
    """chip_smoke's rule for K2 folds narrower than a list: a class may
    keep another point at an equal bf16 value if, by the plain version's
    arithmetic, that point is within 1 bf16 ulp of the class minimum (two
    copies of one vector in one class, here); any other point fails."""
    from chip_smoke import decode, k2_near_ties
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(7, "random", d=12, qc=8), "cpu")
    W = 2
    assert int(counts[0]) > 3 * 128 and int(toff[0]) == 0
    vecs[2] = vecs[0]          # list 0: tiles 0 and 2 share their classes
    args, kw = (q_sel, vecs, toff, counts), dict(fold_tiles=W,
                                                 max_tiles=max_tiles)
    want = scan_exact_csr_reference(*args, **kw)
    _, pos = decode(want.numpy(), True, 0, max_tiles)
    j = int(np.nonzero((pos[0, 0] >= 0) & (pos[0, 0] < 128))[0][0])
    twin = pos[0, 0, j] + 2 * 128
    for moved_to, ok in ((twin, True), (twin + 1, False)):
        got = want.clone()
        got[0, 0, j] = (int(want[0, 0, j]) & ~0xFFFF) | int(moved_to)
        with pytest.raises(AssertionError, match="positions differ"):
            compare_fold(got, want, True, False, 0, max_tiles)
        if ok:
            compare_fold(got, want, True, False, 0, max_tiles,
                         k2_near_ties(args, kw))
        else:
            with pytest.raises(AssertionError, match="positions differ"):
                compare_fold(got, want, True, False, 0, max_tiles,
                             k2_near_ties(args, kw))


def test_wrapper_runs_plain_version_on_cpu():
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(1, "random"), "cpu")
    launches = scan_exact_csr.launches
    got = scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=2,
                         max_tiles=max_tiles)
    want = scan_exact_csr_reference(q_sel, vecs, toff, counts, fold_tiles=2,
                                    max_tiles=max_tiles)
    assert torch.equal(got, want)
    assert scan_exact_csr.launches == launches        # no kernel ran


def test_wrapper_rejects_bad_input():
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(2, "int"), "cpu")
    kw = dict(fold_tiles=1, max_tiles=max_tiles)
    with pytest.raises(ValueError):                   # d_aug mismatch
        scan_exact_csr(q_sel[:, :, :-1], vecs, toff, counts, **kw)
    with pytest.raises(TypeError):
        scan_exact_csr(q_sel.float(), vecs, toff, counts, **kw)
    with pytest.raises(ValueError):
        scan_exact_csr(q_sel, vecs, toff.long(), counts, **kw)
    with pytest.raises(ValueError):                   # > 65,536 positions
        scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=1,
                       max_tiles=513)


@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("s", SLOT_COUNT_CASES)
def test_slot_counts_match_jax_kernel(kind, s):
    qc = 20
    case = exact_case(41, kind, d=12, qc=qc)
    want = _jax_exact(*case, 2)
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(*case, "cpu")
    assert int(counts[3]) == 0 and int(counts[0]) % 128   # empty; ragged
    got = scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=2,
                         max_tiles=max_tiles,
                         slot_counts=slot_counts_for(s, counts, qc))
    n = qc if s is None else s
    assert bool((got[:, n:] == ENC_INVALID).all())
    compare_fold(got[:, :n], torch.from_numpy(want[:, :n].copy()), True,
                 kind == "int", 0, max_tiles)


def test_mixed_slot_counts_match_jax_kernel():
    case = exact_case(42, "int", d=12, qc=20)
    want = torch.from_numpy(_jax_exact(*case, 1).copy())
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(*case, "cpu")
    sc = torch.tensor([20, 9, 0, 3], dtype=torch.int32)
    got = scan_exact_csr(q_sel, vecs, toff, counts, fold_tiles=1,
                         max_tiles=max_tiles, slot_counts=sc)
    for c, n in enumerate(sc.tolist()):
        assert torch.equal(got[c, :n], want[c, :n])
        assert bool((got[c, n:] == ENC_INVALID).all())


def test_bad_slot_counts_are_refused():
    q_sel, vecs, toff, counts, max_tiles = exact_inputs(
        *exact_case(5, "int"), "cpu")
    kw = dict(fold_tiles=1, max_tiles=max_tiles)
    for sc in (counts.long(), counts[:2], counts.to("meta")):
        for fn in (scan_exact_csr, scan_exact_csr_reference):
            with pytest.raises(ValueError):
                fn(q_sel, vecs, toff, counts, slot_counts=sc, **kw)


def test_exact_query_ids_do_not_move_with_slot_counts(monkeypatch):
    """The slot counts mark only slots that no pair reads: the exact
    engine's ids are those of the scan over every slot."""
    X, qs = make_clustered(1500, 16, 96, seed=9)
    ivf = IVF("euclidean", 12, FastPQ(2, device="cpu"), scan_impl="exact",
              device="cpu").fit(X).build(X, n_probes=2)
    seen = []

    def every_slot(*args, slot_counts=None, **kw):
        seen.append(slot_counts)
        return scan_exact_csr(*args, **kw)

    want = ivf.query(qs, k=10, n_probes=3, mode="bucket")
    monkeypatch.setattr(ivf_module, "scan_exact_csr", every_slot)
    got = ivf.query(qs, k=10, n_probes=3, mode="bucket")
    assert torch.equal(got, want)
    assert seen and all(s is not None and s.dtype == torch.int32
                        for s in seen)
    assert int(seen[0].sum()) == len(qs)              # round 0: one per query


CONFIGS = [("euclidean", 1, 1200, 16, 8), ("angular", 2, 1500, 24, 12),
           ("euclidean", 2, 2000, 20, 16)]


def _jax_exact_index(tmp_path, metric, bp, n, d, C, seed=4):
    X, qs = make_clustered(n, d, 100, seed=seed)
    jax_ivf = JaxIVF(metric, C, JaxFastPQ(2), scan_impl="exact",
                     pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=bp)
    path = tmp_path / "index.npz"
    save_ivf(path, jax_ivf)
    return jax_ivf, load_ivf(path, "cpu"), qs


def _sorted_distances(data, ids, qs):
    return np.sort(((data[ids] - qs[:, None, :]) ** 2).sum(-1), axis=1)


@pytest.mark.parametrize("metric, bp, n, d, C", CONFIGS)
def test_port_serves_jax_exact_index(tmp_path, metric, bp, n, d, C):
    jax_ivf, port, qs = _jax_exact_index(tmp_path, metric, bp, n, d, C)
    assert port.scan_impl == "exact" and port.build_probes == bp
    np.testing.assert_array_equal(
        port.csr_vecs.float().numpy()[:, :d], _f32(jax_ivf.csr_vecs)[:, :d])
    data = np.asarray(jax_ivf.data)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True) \
        if metric == "angular" else qs
    for P in (1, 3):
        a, sa = jax_ivf.query(qs, k=10, n_probes=P, mode="bucket",
                              with_stats=True)
        b, sb = port.query(qs, k=10, n_probes=P, with_stats=True)
        assert b.dtype == torch.int32 and tuple(b.shape) == (100, 10)
        for key in ("queries_per_cluster_cap",
                    "queries_per_cluster_cap_round0", "pass_1",
                    "per_pair_candidates", "dropped_probe_pairs"):
            assert sb[key] == sa[key], key
        # The scan ranks by bf16-rounded distances, and the port's sums run
        # in another order than XLA's, so a bf16 tie at the selection
        # boundary may send one query another candidate: at most 1 query
        # in 100 may differ.
        da = _sorted_distances(data, np.asarray(a), qn)
        db = _sorted_distances(data, b.numpy(), qn)
        close = np.isclose(da, db, rtol=1e-5).all(axis=1)
        assert (~close).sum() <= len(qs) // 100, np.flatnonzero(~close)


def test_set_scan_impl_switches_engines():
    X, qs = make_clustered(800, 16, 20, seed=6)
    ivf = IVF("euclidean", 8, FastPQ(2, device="cpu"),
              device="cpu").fit(X).build(X, n_probes=1)
    assert ivf.csr_vecs is None
    pq_ids = ivf.query(qs, 5, mode="bucket")
    ivf.set_scan_impl("exact")
    assert ivf.csr_vecs.shape == (ivf.csr_codes.shape[0], 32, 128)
    exact_ids = ivf.query(qs, 5, mode="bucket")
    truth = ((X[None] - qs[:, None]) ** 2).sum(-1)
    got = np.take_along_axis(truth, exact_ids.numpy(), 1).sum()
    assert got <= np.take_along_axis(truth, pq_ids.numpy(), 1).sum()
    ivf.set_scan_impl("auto")
    assert ivf.csr_vecs is None
    torch.testing.assert_close(ivf.query(qs, 5, mode="bucket"), pq_ids)
    # the 'xla' engine scans the same codes in plain torch and keeps an
    # exact top-r per pair where the fold keeps one point per class: at
    # least 0.9 of the fused ids, never better than the exact engine
    ivf.set_scan_impl("xla")
    assert ivf.csr_vecs is None and ivf._scan_engine() == "xla"
    xla_ids = ivf.query(qs, 5, mode="bucket").numpy()
    overlap = np.mean([len(set(a) & set(b)) / 5
                       for a, b in zip(xla_ids, pq_ids.numpy())])
    assert overlap >= 0.9, overlap
    assert got <= np.take_along_axis(truth, xla_ids, 1).sum()
    with pytest.raises(ValueError, match="scan_impl"):
        ivf.set_scan_impl("pallas")


def test_exact_list_too_long_raises():
    X, _ = make_clustered(300, 16, 4, seed=1)
    ivf = IVF("euclidean", 4, FastPQ(2, device="cpu"),
              device="cpu").fit(X).build(X, n_probes=1)
    ivf.max_tiles = 513           # as if one list held 65,537+ points
    with pytest.raises(ValueError, match="16-bit"):
        ivf.set_scan_impl("exact")
