"""The query path's stage spans and counters (utils/timing.py): the
``tinyknn.*`` ranges a ``torch.profiler`` session records inside
``IVF.query`` and ``IVF.query_stream``, the one check a span costs with
no session, and ``counters``' passes, dropped and lost pairs."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyknn_tpu_torch import IVF, FastPQ
from tinyknn_tpu_torch.models import ivf as ivf_module
from tinyknn_tpu_torch.utils import timing
from tinyknn_tpu_torch.utils.datasets import make_clustered

STAGES = ("tinyknn.tables", "tinyknn.probes", "tinyknn.bucket",
          "tinyknn.scan", "tinyknn.pool", "tinyknn.rescore")


@pytest.fixture(scope="module")
def index():
    X, qs = make_clustered(2000, 16, 64, seed=7)
    ivf = IVF("euclidean", 16, FastPQ(2, device="cpu"), device="cpu")
    return ivf.fit(X).build(X, n_probes=1), X, qs


def _spans(fn):
    """(start ns, end ns, name) of the ``tinyknn.*`` ranges recorded
    while ``fn()`` runs under a CPU profiler session, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("tinyknn.")]
    return sorted(spans)


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def _names(spans, name):
    return [s for s in spans if s[2] == name]


def _skewed(X, n):
    """``n`` near-copies of one point: all land in one list, past round
    0's capacity."""
    rng = np.random.default_rng(0)
    return (X[5] + 0.01 * rng.standard_normal((n, X.shape[1]))).astype(
        np.float32)


def _delta(fn):
    before = dict(timing.counters)
    out = fn()
    return out, {k: timing.counters[k] - before[k] for k in before}


def test_bucket_query_spans_nest_on_one_clock(index):
    ivf, _, qs = index
    spans = _spans(lambda: ivf.query(qs, k=5, n_probes=3, mode="bucket"))
    (query,) = _names(spans, "tinyknn.query")
    (attempt,) = _names(spans, "tinyknn.attempt")
    assert not _names(spans, "tinyknn.retry")
    assert not _names(spans, "tinyknn.gather")
    (inp,) = _names(spans, "tinyknn.input")
    assert _inside(inp, query) and inp[1] <= attempt[0]
    assert _inside(attempt, query)
    for name in STAGES:
        found = _names(spans, name)
        # two scan rounds (each query's nearest list, then its others)
        assert len(found) == (2 if name in ("tinyknn.bucket",
                                            "tinyknn.scan") else 1), name
        assert all(_inside(s, attempt) for s in found), name
    (drop,) = _names(spans, "tinyknn.drop_check")
    assert _inside(drop, query) and drop[0] >= attempt[1]
    # every two ranges are nested or disjoint, and the stages run in order
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            assert b[0] >= a[1] or _inside(b, a), (a, b)
    order = [s[2] for s in spans if s[2] in STAGES]
    assert order == ["tinyknn.tables", "tinyknn.probes", "tinyknn.bucket",
                     "tinyknn.scan", "tinyknn.bucket", "tinyknn.scan",
                     "tinyknn.pool", "tinyknn.rescore"]


def test_span_enters_no_profiler_range_without_a_session(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = timing.span("tinyknn.query")
    assert timing.span("tinyknn.scan") is first
    with first:
        pass
    X, qs = make_clustered(600, 8, 40, seed=3)
    ivf = IVF("euclidean", 6, FastPQ(2, device="cpu"), device="cpu")
    ivf.fit(X).build(X, n_probes=1)
    assert ivf.query(qs, k=3, n_probes=2, mode="bucket").shape == (40, 3)
    assert ivf.query(qs[:2], k=3, n_probes=2, mode="gather").shape == (2, 3)
    assert ivf.query_stream(qs.reshape(2, 20, 8), k=3,
                            n_probes=2).shape == (2, 20, 3)


def test_a_retry_counts_its_pass_and_the_first_pass_drops(index):
    ivf, X, _ = index
    qs = _skewed(X, 100)
    params = ivf_module._query_params(ivf, 100, 5, 2, None)
    _, first_drops = ivf._bucket_query(torch.as_tensor(qs), params,
                                       ivf._scan_engine())
    first_drops = int(first_drops)
    assert first_drops > 0
    holder = {}

    def run():
        holder["out"] = _delta(lambda: ivf.query(
            qs, k=5, n_probes=2, mode="bucket", with_stats=True))

    spans = _spans(run)
    (_, stats), delta = holder["out"]
    assert stats["dropped_probe_pairs"] == 0
    assert stats["queries_per_cluster_cap_round0"] > params[6]
    # each round's overflow grid (room for max(qc, qc0) pairs) rescues
    # what it holds; the drops past it are counted and send the batch to
    # the retry
    assert delta["query.attempts"] == 2
    assert 0 < delta["query.rescued_pairs"] <= 2 * max(params[5:])
    assert delta["query.dropped_pairs"] > 0
    assert (delta["query.dropped_pairs"] + delta["query.rescued_pairs"]
            == first_drops)
    assert delta["query.lost_pairs"] == 0
    (query,) = _names(spans, "tinyknn.query")
    (attempt,) = _names(spans, "tinyknn.attempt")
    (retry,) = _names(spans, "tinyknn.retry")
    assert attempt[1] <= retry[0] and _inside(retry, query)
    for name in STAGES:
        assert len([s for s in _names(spans, name)
                    if _inside(s, retry)]) >= 1, name
    assert len(_names(spans, "tinyknn.drop_check")) == 2


@pytest.mark.parametrize("qc", [8, 16, 32])
def test_a_pinned_batch_loses_the_pairs_it_drops(index, qc):
    """Capacities pinned by ``queries_per_cluster``: one pass, no retry,
    so every pair it drops is lost, as ``with_stats`` reports it."""
    ivf, X, qs = index
    batch = np.concatenate([qs, _skewed(X, 40)])
    ivf.queries_per_cluster = qc
    try:
        (_, stats), delta = _delta(lambda: ivf.query(
            batch, k=5, n_probes=2, mode="bucket", with_stats=True))
    finally:
        ivf.queries_per_cluster = None
    assert stats["dropped_probe_pairs"] > 0
    assert delta == {"query.attempts": 1,
                     "query.dropped_pairs": stats["dropped_probe_pairs"],
                     "query.rescued_pairs": 0,
                     "query.lost_pairs": stats["dropped_probe_pairs"]}


def test_xla_drops_past_clamped_caps_are_lost(index, monkeypatch):
    """The 'xla' engine scans no overflow grid: with the caps clamped to
    the first pass's capacities by ``scan_budget_bytes``, its three
    passes drop alike, and the last pass's drops are the lost pairs."""
    ivf, X, qs = index
    batch = np.concatenate([qs, _skewed(X, 100)])
    monkeypatch.setattr(ivf, "scan_impl", "xla")
    monkeypatch.setattr(ivf, "scan_budget_bytes", 1)
    (_, stats), delta = _delta(lambda: ivf.query(
        batch, k=5, n_probes=2, mode="bucket", with_stats=True))
    assert delta["query.attempts"] == 3 and delta["query.rescued_pairs"] == 0
    assert stats["dropped_probe_pairs"] > 0
    assert delta["query.lost_pairs"] == stats["dropped_probe_pairs"]
    assert delta["query.dropped_pairs"] == 3 * stats["dropped_probe_pairs"]


def test_query_stream_counts_one_pass_per_batch(index):
    ivf, X, qs = index
    stream = np.stack([qs[:32], qs[32:], _skewed(X, 32)])
    holder = {}

    def run():
        holder["out"] = _delta(lambda: ivf.query_stream(
            stream, k=5, n_probes=2, with_stats=True, adaptive_qc=False))

    spans = _spans(run)
    (_, stats), delta = holder["out"]
    assert delta == {"query.attempts": 3,
                     "query.dropped_pairs": stats["dropped_probe_pairs"],
                     "query.rescued_pairs": 0,
                     "query.lost_pairs": stats["dropped_probe_pairs"]}
    assert stats["dropped_probe_pairs"] > 0
    (call,) = _names(spans, "tinyknn.query_stream")
    assert len(_names(spans, "tinyknn.scan")) == 6
    assert all(_inside(s, call) for s in spans)
    # device_out reads no drop count, so it counts no dropped pair
    _, delta = _delta(lambda: ivf.query_stream(
        stream, k=5, n_probes=2, adaptive_qc=False, device_out=True))
    assert delta == {"query.attempts": 3, "query.dropped_pairs": 0,
                     "query.rescued_pairs": 0, "query.lost_pairs": 0}


def test_gather_mode_is_one_gather_span_and_no_pass(index):
    ivf, _, qs = index
    holder = {}

    def run():
        holder["out"] = _delta(lambda: ivf.query(qs[:4], k=5, n_probes=2,
                                                 mode="auto",
                                                 with_stats=True))

    spans = _spans(run)
    (_, stats), delta = holder["out"]
    assert stats["mode"] == "gather"
    assert delta == {"query.attempts": 0, "query.dropped_pairs": 0,
                     "query.rescued_pairs": 0, "query.lost_pairs": 0}
    (query,) = _names(spans, "tinyknn.query")
    (gather,) = _names(spans, "tinyknn.gather")
    assert _inside(gather, query)
    assert {s[2] for s in spans} == {"tinyknn.query", "tinyknn.input",
                                     "tinyknn.gather"}


def test_profile_trace_writes_the_stages(index, tmp_path):
    ivf, _, qs = index
    with timing.profile_trace(tmp_path):
        ivf.query(qs, k=5, n_probes=2, mode="bucket")
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"tinyknn.query", "tinyknn.attempt", *STAGES} <= names
