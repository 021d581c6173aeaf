"""``IVF.query``'s overflow grid, on the CPU.

A batch whose round 0 (and, at P=3, its tail round) overflows a bucket
by fewer pairs than the round's capacity: the first pass scans the
overflowing pairs in an overflow grid and answers with no retry. Its
ids and distances are those of the same batch at the can't-drop caps
(the first attempt's fold widths), and its sorted distances those of the
JAX package, which retries; ``query.rescued_pairs`` counts the raw
first-pass drops. A batch that drops nothing rescues nothing and
answers as before. ``query.lost_pairs`` counts only the pairs that no
pass scanned: none once the escalation ends at the can't-drop caps,
every drop where nothing retries. A round's grid holds one pair a grid
list where its drops may lie one a list, and groups of one list's
pairs where they must crowd. Engines: 'fused' with int8 and bf16
tables, 'exact'.
"""

import numpy as np
import pytest
import torch

from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu.io import save_ivf
from tinyknn_tpu_torch import load_ivf, make_clustered
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.utils import timing

ENGINES = [("fused", "int8"), ("fused", "bf16"), ("exact", "int8")]
N_NEAR = 50   # near-copies of one point: past round 0's 32 slots by < 32


@pytest.fixture(scope="module", params=ENGINES, ids=lambda e: "-".join(e))
def pair(request, tmp_path_factory):
    """(JAX index, the port serving it, spread queries, near-copies)."""
    scan_impl, table_dtype = request.param
    X, qs = make_clustered(2000, 16, 100, seed=5)
    jax_ivf = JaxIVF("euclidean", 16, JaxFastPQ(2, table_dtype=table_dtype),
                     scan_impl=scan_impl, pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=1)
    path = tmp_path_factory.mktemp("rescue") / "index.npz"
    save_ivf(path, jax_ivf)
    rng = np.random.default_rng(0)
    near = (X[5] + 0.01 * rng.standard_normal((N_NEAR, 16))).astype(
        np.float32)
    return jax_ivf, load_ivf(path, "cpu"), qs, near


def _delta(fn):
    before = dict(timing.counters)
    out = fn()
    return out, {k: timing.counters[k] - before[k] for k in before}


def _sorted_distances(data, ids, qs):
    return np.sort(((data[ids] - qs[:, None, :]) ** 2).sum(-1), axis=1)


def _assert_as_jax(jax_ivf, port, qs, ids, P):
    """The JAX package retries up to caps that hold every pair at its
    default budget and finds the same neighbours: equal sorted
    distances."""
    a = np.asarray(jax_ivf.query(qs, k=10, n_probes=P, mode="bucket"))
    data = np.asarray(jax_ivf.data)
    close = np.isclose(_sorted_distances(data, a, qs),
                       _sorted_distances(data, ids.numpy(), qs),
                       rtol=1e-5).all(axis=1)
    if port.scan_impl == "exact":
        # bf16 ties at the selection boundary (see test_torch_exact.py)
        assert (~close).sum() <= len(qs) // 100, np.flatnonzero(~close)
    else:
        assert close.all(), np.flatnonzero(~close)


def _raw_drops(port, qs, P):
    """The first pass's drops without the overflow grid, and its
    params."""
    params = ivf_module._query_params(port, len(qs), 10, P, None)
    _, drops = port._bucket_query(torch.as_tensor(qs), params,
                                  port._scan_engine())
    return int(drops), params


@pytest.mark.parametrize("P", [1, 3])
def test_overflow_grid_answers_as_the_caps_do(pair, P):
    jax_ivf, port, spread, near = pair
    qs = np.concatenate([spread, near])
    raw, params = _raw_drops(port, qs, P)
    raw_round0, _ = _raw_drops(port, qs, 1)
    assert 0 < raw_round0 <= params[6]
    if P > 1:
        assert raw > raw_round0       # the tail round overflows too
    (ids, stats), delta = _delta(lambda: port.query(
        qs, k=10, n_probes=P, mode="bucket", with_stats=True))
    assert delta == {"query.attempts": 1, "query.dropped_pairs": 0,
                     "query.rescued_pairs": raw, "query.lost_pairs": 0}
    assert stats["dropped_probe_pairs"] == 0
    assert (stats["queries_per_cluster_cap"],
            stats["queries_per_cluster_cap_round0"]) == params[5:]
    # the same batch at the can't-drop caps, at the first attempt's r
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    caps = ivf_module._qc_caps(port, len(qs), n_probes, r, r_tail, qc, qc0)
    want, drops = port._bucket_query(
        torch.as_tensor(qs), (k, n_probes, pass_1, r, r_tail, *caps),
        port._scan_engine())
    assert int(drops) == 0
    np.testing.assert_array_equal(ids.numpy(), want.numpy())
    _assert_as_jax(jax_ivf, port, qs, ids, P)


@pytest.mark.parametrize("P", [1, 3])
def test_a_batch_with_no_drops_rescues_nothing(pair, P):
    _, port, spread, _ = pair
    raw, params = _raw_drops(port, spread, P)
    assert raw == 0
    (ids, stats), delta = _delta(lambda: port.query(
        spread, k=10, n_probes=P, mode="bucket", with_stats=True))
    assert delta == {"query.attempts": 1, "query.dropped_pairs": 0,
                     "query.rescued_pairs": 0, "query.lost_pairs": 0}
    want, _ = port._bucket_query(torch.as_tensor(spread), params,
                                 port._scan_engine())
    np.testing.assert_array_equal(ids.numpy(), want.numpy())


def test_the_grid_takes_the_first_pairs_and_counts_the_rest():
    """``_overflow_grid`` on a hand-made round: list 0 holds 2 slots and
    gets 6 pairs, of which 4 overflow; a grid of 3 takes the first 3 in
    pair order, and entries past the drops are empty."""
    probe_sub = torch.tensor([[0], [1], [0], [0], [2], [0], [0], [0]])
    C, qc = 3, 2
    _, _, in_slot, dropped = ivf_module._bucket_pairs(probe_sub, C, qc)
    assert int(dropped) == 4
    tables = torch.arange(8 * 4, dtype=torch.int8).reshape(8, 4)
    toff = torch.tensor([5, 7, 9], dtype=torch.int32)
    counts = torch.tensor([100, 3, 4], dtype=torch.int32)
    for O, pairs, left in ((3, [3, 5, 6], 1), (6, [3, 5, 6, 7, 0, 0], 0)):
        pair, t, off, cnt, filled, drops = ivf_module._overflow_grid(
            probe_sub, in_slot, dropped, tables, toff, counts, O)
        assert pair.tolist() == pairs
        n = min(4, O)
        assert filled.tolist() == [1] * n + [0] * (O - n)
        assert drops.tolist() == [left, 4 - left]
        assert t.shape == (O, 1, 4)
        assert torch.equal(t[:, 0], tables[pair])
        assert off[:n].tolist() == [5] * n and cnt[:n].tolist() == [100] * n


def test_the_grouped_grid_packs_each_lists_drops():
    """``_overflow_groups`` in groups of 3 slots, on a hand-made round:
    list 0 holds 2 slots and gets 6 pairs (4 dropped), list 2 gets 3 (1
    dropped); the groups take list 0's drops in pair order, then list
    2's, each group filled from its first slot, and the drops past the
    grid's room or its O groups stay dropped."""
    probe_sub = torch.tensor([[0], [1], [0], [0], [2], [0], [0], [0], [2],
                              [2]])
    C, qc = 3, 2
    _, _, in_slot, dropped = ivf_module._bucket_pairs(probe_sub, C, qc)
    assert int(dropped) == 5
    tables = torch.arange(10 * 4, dtype=torch.int8).reshape(10, 4)
    toff = torch.tensor([5, 7, 9], dtype=torch.int32)
    counts = torch.tensor([100, 3, 4], dtype=torch.int32)
    # an empty slot repeats its group's first pair, and an empty group's
    # slots the pair of the group's index, whose list the group scans
    for room, O, pairs, filled, lists, left in (
            (5, 4, [[3, 5, 6], [7, 7, 7], [9, 9, 9], [3, 3, 3]],
             [3, 1, 1, 0], [0, 0, 2, 0], 0),
            (4, 4, [[3, 5, 6], [7, 7, 7], [2, 2, 2], [3, 3, 3]],
             [3, 1, 0, 0], [0, 0, 0, 0], 1),
            (2, 2, [[3, 5, 3], [1, 1, 1]], [2, 0], [0, 1], 3),
            (5, 1, [[3, 5, 6]], [3], [0], 2)):
        pair, t, off, cnt, got, drops = ivf_module._overflow_groups(
            probe_sub, in_slot, dropped, tables, toff, counts, room, O,
            q=3)
        assert pair.tolist() == pairs and got.tolist() == filled
        assert off.tolist() == toff[lists].tolist()
        assert cnt.tolist() == counts[lists].tolist()
        assert drops.tolist() == [left, 5 - left]
        assert torch.equal(t, tables[pair])


@pytest.mark.parametrize("scan_impl", ["fused", "exact"])
def test_spread_drops_take_one_slot_a_list(scan_impl, tmp_path, monkeypatch):
    """With 64 lists, round 0's drops may lie one a list (its 640 pairs
    can overflow 19 lists, more than half the grid's room of 32), so
    the grid holds one pair a grid list (``_overflow_grid``, no sort):
    the near-copies' overflow is rescued in one pass, and the batch
    answers as at the can't-drop caps and as the JAX package."""
    X, qs = make_clustered(6000, 16, 600, seed=7)
    jax_ivf = JaxIVF("euclidean", 64, JaxFastPQ(2), scan_impl=scan_impl,
                     pass1_method="exact")
    jax_ivf.fit(X).build(X, n_probes=1)
    save_ivf(tmp_path / "index.npz", jax_ivf)
    port = load_ivf(tmp_path / "index.npz", "cpu")
    rng = np.random.default_rng(0)
    near = X[5] + 0.01 * rng.standard_normal((30, 16))
    batch = np.concatenate([qs, near]).astype(np.float32)
    forms = []
    for name in ("_overflow_grid", "_overflow_groups"):
        def spy(*args, _form=getattr(ivf_module, name), _name=name, **kw):
            forms.append(_name)
            return _form(*args, **kw)
        monkeypatch.setattr(ivf_module, name, spy)
    raw, params = _raw_drops(port, batch, 1)
    assert 0 < raw <= params[6]
    (ids, stats), delta = _delta(lambda: port.query(
        batch, k=10, n_probes=1, mode="bucket", with_stats=True))
    assert forms == ["_overflow_grid"]
    assert delta == {"query.attempts": 1, "query.dropped_pairs": 0,
                     "query.rescued_pairs": raw, "query.lost_pairs": 0}
    k, n_probes, pass_1, r, r_tail, qc, qc0 = params
    caps = ivf_module._qc_caps(port, len(batch), 1, r, r_tail, qc, qc0)
    want, drops = port._bucket_query(
        torch.as_tensor(batch), (k, 1, pass_1, r, r_tail, *caps),
        port._scan_engine())
    assert int(drops) == 0
    np.testing.assert_array_equal(ids.numpy(), want.numpy())
    _assert_as_jax(jax_ivf, port, batch, ids, 1)


def test_pinned_and_stream_paths_keep_their_drops(pair):
    """No overflow grid where the JAX package reports drops: a pinned
    capacity and ``query_stream`` drop the same pairs as the raw pass."""
    _, port, spread, near = pair
    qs = np.concatenate([spread, near])
    raw, _ = _raw_drops(port, qs, 1)
    (_, stats), delta = _delta(lambda: port.query_stream(
        qs[None], k=10, n_probes=1, with_stats=True, adaptive_qc=False))
    assert stats["dropped_probe_pairs"] == raw > 0
    assert delta["query.rescued_pairs"] == 0
    port.queries_per_cluster = 32
    try:
        (ids, stats), delta = _delta(lambda: port.query(
            qs, k=10, n_probes=1, mode="bucket", with_stats=True))
    finally:
        port.queries_per_cluster = None
    assert stats["dropped_probe_pairs"] == raw
    assert delta == {"query.attempts": 1, "query.dropped_pairs": raw,
                     "query.rescued_pairs": 0, "query.lost_pairs": raw}


def test_chip_smoke_skewed_batch_escalates(pair, monkeypatch):
    """chip_smoke's skewed batch (phases 4 and 5) on a small index: the
    overflow grid overflows too, so the query retries, drops nothing and
    answers as the same batch at the can't-drop caps."""
    import chip_smoke
    _, port, spread, _ = pair
    monkeypatch.setattr(chip_smoke, "torch_sync", lambda: None)
    skew = chip_smoke.skewed_batch(spread)
    got = chip_smoke.skewed_check(port, skew, None, "small", "cpu")
    assert got["attempts"] >= 2 and got["rescued"] == got["qc0"]
    assert got["dropped"] == 0 and got["fullest_list"] > 2 * got["qc0"]
    assert got["qc0"] < got["retry_qc0"] <= got["used_qc0"] <= got["caps_qc0"]


def test_chip_smoke_clamped_caps_are_scanned(pair, monkeypatch):
    """chip_smoke's skewed batch with the caps clamped below the fullest
    list (phase 4): the caps pass rescues every pair past them, and the
    batch answers as at capacities that hold every pair."""
    import chip_smoke
    _, port, spread, _ = pair
    monkeypatch.setattr(chip_smoke, "torch_sync", lambda: None)
    skew = chip_smoke.skewed_batch(spread)
    got = chip_smoke.skewed_check(port, skew, None, "small", "cpu",
                                  clamp=True)
    assert got["attempts"] == 3 and got["past_caps"] > 0
    assert got["rescued"] == got["qc0"] + got["past_caps"]
    assert got["dropped"] == got["lost"] == 0
    assert got["caps_qc0"] == 2 * got["qc0"] < got["fullest_list"]


def test_chip_smoke_sift_shape_phase(monkeypatch):
    """chip_smoke's phase 4c at a small size: 32 real blocks, P=6, both
    rounds' caps clamped and scanned in their grids, every K1 shape
    held (here the plain version against itself)."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "torch_sync", lambda: None)
    shape = dict(chip_smoke.SIFT_SHAPE, size=8000, n_clusters=64,
                 n_queries=10, near=600)
    got, err = chip_smoke.sift_shape_path("cpu", "cpu", shape)
    assert got["blocks"] == 32 and min(got["past_caps"]) > 0
    assert err == 0.0
    # round 0's and the tail round's grids, in the first and the last pass
    assert len(got["grids"]) == 4 and all(got["grids"].values())


def test_an_escalated_batch_loses_no_pair(pair):
    """The skewed batch overflows past the grid: its passes drop pairs,
    the last one none, so no pair is lost."""
    import chip_smoke
    _, port, spread, _ = pair
    skew = chip_smoke.skewed_batch(spread)
    (_, stats), delta = _delta(lambda: port.query(
        skew, k=10, n_probes=1, mode="bucket", with_stats=True))
    assert delta["query.attempts"] >= 2
    assert delta["query.dropped_pairs"] > 0
    assert stats["dropped_probe_pairs"] == delta["query.lost_pairs"] == 0


@pytest.mark.parametrize("P", [1, 3])
def test_clamped_caps_scan_the_rest_in_a_grid(pair, monkeypatch, P):
    """Caps clamped by ``scan_budget_bytes`` below the fullest list (at
    P=3 in round 0 and in the tail round): the last pass scans what they
    cannot hold in overflow grids sized by the 4x pass's drops and loses
    nothing. Its ids are those of the same batch at caps that hold every
    pair, and its sorted distances those of the JAX package, whose caps
    hold every pair at its default budget."""
    import chip_smoke
    jax_ivf, port, spread, _ = pair
    skew = chip_smoke.skewed_batch(spread)
    Q = len(skew)
    k, _, pass_1, r, r_tail, qc, qc0 = ivf_module._query_params(
        port, Q, 10, P, None)
    full = ivf_module._qc_caps(port, Q, P, r, r_tail, qc, qc0)
    want, drops = port._bucket_query(
        torch.as_tensor(skew), (k, P, pass_1, r, r_tail, *full),
        port._scan_engine())
    assert int(drops) == 0
    s0_w = ivf_module._fold_tiles(r, port.max_tiles,
                                  port.fold_mult) * ivf_module.LANE_TILE
    C = port.active_centers.shape[0]
    monkeypatch.setattr(port, "scan_budget_bytes", 4 * C * s0_w * 2 * qc0)
    caps = ivf_module._qc_caps(port, Q, P, r, r_tail, qc, qc0)
    probes = ivf_module._probe_select(torch.as_tensor(skew),
                                      port.active_centers, P)
    assert caps[1] == 2 * qc0 < int(torch.bincount(probes[:, 0]).max())
    if P > 1:
        assert caps[0] < int(torch.bincount(probes[:, 1:].reshape(-1)).max())
    (ids, stats), delta = _delta(lambda: port.query(
        skew, k=10, n_probes=P, mode="bucket", with_stats=True))
    assert delta["query.attempts"] == 3
    assert stats["queries_per_cluster_cap_round0"] == caps[1]
    assert stats["dropped_probe_pairs"] == delta["query.lost_pairs"] == 0
    np.testing.assert_array_equal(ids.numpy(), want.numpy())
    _assert_as_jax(jax_ivf, port, skew, ids, P)


@pytest.mark.parametrize("adaptive_qc", [False, True])
def test_stream_drops_are_lost(pair, adaptive_qc):
    """``query_stream`` has no retry: every drop its host path reads is
    lost (with measured floors, none at this budget)."""
    _, port, spread, near = pair
    qs = np.concatenate([spread, near])
    raw, _ = _raw_drops(port, qs, 1)
    port._stream_qc_floors = {}
    (_, stats), delta = _delta(lambda: port.query_stream(
        qs[None], k=10, n_probes=1, with_stats=True,
        adaptive_qc=adaptive_qc))
    want = 0 if adaptive_qc else raw
    assert stats["dropped_probe_pairs"] == want
    assert delta["query.dropped_pairs"] == delta["query.lost_pairs"] == want
