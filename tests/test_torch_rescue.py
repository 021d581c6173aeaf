"""``IVF.query``'s overflow grid, on the CPU.

A batch whose round 0 (and, at P=3, its tail round) overflows a bucket
by fewer pairs than the round's capacity: the first pass scans the
overflowing pairs in an overflow grid and answers with no retry. Its
ids and distances are those of the same batch at the can't-drop caps
(the first attempt's fold widths), and its sorted distances those of the
JAX package, which retries; ``query.rescued_pairs`` counts the raw
first-pass drops. A batch that drops nothing rescues nothing and
answers as before. Engines: 'fused' with int8 and bf16 tables, 'exact'.
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
                     "query.rescued_pairs": raw}
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
    # the JAX package retries and finds the same neighbours
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


@pytest.mark.parametrize("P", [1, 3])
def test_a_batch_with_no_drops_rescues_nothing(pair, P):
    _, port, spread, _ = pair
    raw, params = _raw_drops(port, spread, P)
    assert raw == 0
    (ids, stats), delta = _delta(lambda: port.query(
        spread, k=10, n_probes=P, mode="bucket", with_stats=True))
    assert delta == {"query.attempts": 1, "query.dropped_pairs": 0,
                     "query.rescued_pairs": 0}
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
                     "query.rescued_pairs": 0}


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
