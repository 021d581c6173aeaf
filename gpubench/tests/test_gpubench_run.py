"""Whole runs of each cell at a small size on the CPU: sound runs come
out correct; the control and runs with the timed path broken do not."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import control
from gpubench.tests.smallrun import (BENCH, CHECKOUT, cells, override,
                                     pq_cells, quiet, run, scan_impl)

CELLS = cells()
FIT = ("centers_fit_off", "codebooks_fit_off")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert set(r) == {"correct", "attempted", "failed", "metrics",
                      "device", "checks"}
    assert list(r)[-1] == "checks" and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 3
    assert set(FIT) <= set(r["checks"])
    assert all(c["value"] == 0.0 for name, c in r["checks"].items()
               if name not in FIT)
    assert 0.5 < r["metrics"]["recall10_at_10"]["value"] < 1.0 or \
        scan_impl(cell) == "exact"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(cell):
    r = run(cell, trace=True)
    assert r["correct"]
    assert {"kmeans_fit_s", "list_build_s", "scan_launches_per_batch",
            "query_attempts_per_batch",
            "rescued_pairs_per_batch"} <= set(r["metrics"])
    assert r["metrics"]["query_attempts_per_batch"]["value"] >= 1.0
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _wrap(broken):
    """A fault that replaces the entry's query by ``broken(query)``."""
    def fault(entry):
        entry.query = broken(entry.query)
    fault.__name__ = broken.__name__
    return fault


@_wrap
def stale(query):
    """A step that returns its state unchanged: each call answers with
    what the last one returned."""
    last = []

    def call(q, mode):
        out = query(q, mode)
        if last:
            out, last[0] = last[0], out
        else:
            last.append(out)
        return out
    return call


@_wrap
def unwritten(query):
    """The answer buffer is returned as allocated, never written."""
    def call(q, mode):
        out = query(q, mode)
        return torch.zeros_like(out)
    return call


@_wrap
def half_left_out(query):
    """Half of the batch left out: the first half is answered twice."""
    def call(q, mode):
        h = (q.shape[0] + 1) // 2
        out = query(np.ascontiguousarray(q[:h]), mode)
        return torch.cat([out, out])[:q.shape[0]]
    return call


@_wrap
def altered(query):
    """An answer altered where it is produced: one id of each answer."""
    def call(q, mode):
        out = query(q, mode).clone()
        out[:, -1] = (out[:, -1] + 7919) % 30000
        return out
    return call


def one_lloyd_pass(entry):
    """The fit cut to one Lloyd pass, coarse centers and codebooks."""
    entry.ivf.kmeans_iters = entry.ivf.pq.kmeans_iters = 1


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, unwritten, half_left_out, altered,
                                   one_lloyd_pass],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    assert not run(cell, fault=fault)["correct"]


@pytest.mark.parametrize("cell", pq_cells())
def test_a_cut_fit_fails_the_fit_numbers(cell):
    checks = run(cell, fault=one_lloyd_pass)["checks"]
    assert all(checks[n]["value"] > checks[n]["limit"] for n in FIT)
    assert checks["answers_off"]["value"] == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    (res,) = control.run(cell, [7], bench_file=BENCH, device="cpu",
                         override=override(cell), log=quiet)
    _, numbers, correct, _ = res
    assert not correct
    assert numbers["answers_off"] > 0.02


@pytest.mark.parametrize("cell", CELLS)
def test_run_py_without_a_card_prints_no_result(cell):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        cell, "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "metrics" not in p.stdout
