"""The traffic kind ``closed_batch``: one client sends ``batch`` test
queries as one call, again and again, each call as soon as the last
one's ids are on the host (ANN-Benchmarks' batch mode). The calls cycle
through ``orders`` batches, each a different order (and, below the whole
test set, a different choice) of the test queries drawn from the seed,
so that no call repeats the last one's input. The batches are made in
set-up: a copy of the queries per call would put the client's own host
work into the window. A mix of this kind: ``{"kind": "closed_batch",
"batch": <Q>, "orders": <n>, "mode": <the entry's query mode>}``."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np


def plan(mix: dict, seed: int, seconds: float, queries: np.ndarray, k: int):
    """The run's client: its batches, each with its test rows."""
    del seconds                     # the loop runs until the time is up
    rng = np.random.default_rng(seed)
    n = queries.shape[0]
    Q = min(int(mix["batch"]), n)
    rows = [rng.permutation(n)[:Q] for _ in range(int(mix["orders"]))]
    return SimpleNamespace(rows=rows, k=k, mode=mix["mode"],
                           batches=[np.ascontiguousarray(queries[r])
                                    for r in rows])


def warm(query, p):
    """Two calls of the window's one shape (the first builds the
    kernels), on the last batch, so that the window's first call sends
    another."""
    for _ in range(2):
        query(p.batches[-1], p.mode).cpu()


def _answer(host, Q: int, k: int):
    """The ids as answered, or all -1 (and a failure) when their shape
    is not (Q, k)."""
    if host.shape == (Q, k):
        return host, 0
    return np.full((Q, k), -1, dtype=np.int64), 1


def serve(query, p, seconds: float, span):
    """Calls until ``seconds`` have passed. The answers are kept once per
    batch and distinct content, with the number of calls that gave
    them."""
    Q, k, M = p.rows[0].shape[0], p.k, len(p.batches)
    seen = [[] for _ in range(M)]      # per batch: [answers, calls]
    calls, failed, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        j = i % M
        t1 = time.perf_counter()
        with span("gpubench.query"):
            ids = query(p.batches[j], p.mode)
        with span("gpubench.ids_to_host"):
            host = ids.cpu().numpy()
        t2 = time.perf_counter()
        calls.append((Q, t2 - t1))
        host, bad = _answer(host, Q, k)
        failed += bad
        if seen[j] and np.array_equal(seen[j][-1][0], host):
            seen[j][-1][1] += 1
        else:
            seen[j].append([host, 1])
        i += 1
        if t2 - t0 >= seconds:
            break
    kept = [(p.rows[j], a, c) for j in range(M) for a, c in seen[j]]
    return SimpleNamespace(
        window_s=t2 - t0, queries=Q * len(calls), calls=calls, batch=Q,
        attempted=len(calls), failed=failed,
        rows=[r for r, _, _ in kept], ids=[a for _, a, _ in kept],
        weights=[np.full(Q, float(c)) for _, _, c in kept])
