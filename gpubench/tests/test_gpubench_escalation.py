"""A batch that overflows past the first pass's overflow grid, at the
small size: ``query()`` escalates (4x, then the can't-drop caps), and
the run stays correct with no pair lost; a program whose escalation
gives up early loses pairs, and ``lost_pairs_per_batch`` says so."""

import numpy as np
import pytest

from gpubench.tests.smallrun import cells, run

N_NEAR = 200    # near-copies of one test query: past round 0's grid


def skewed(entry):
    """The test set with ``N_NEAR`` near-copies of its first query (1%
    noise), which all land in that query's list."""
    q = entry.queries
    rng = np.random.default_rng(0)
    near = q[0] + 0.01 * np.abs(q[0]).mean() * rng.standard_normal(
        (N_NEAR, q.shape[1]))
    entry.queries = np.concatenate([q, near.astype(np.float32)])


def _metric(r, name):
    return r["metrics"][name]["value"]


@pytest.mark.parametrize("cell", cells())
def test_an_escalated_batch_is_correct_and_loses_nothing(cell):
    r = run(cell, trace=True, fault=skewed)
    assert r["correct"], r["checks"]
    assert _metric(r, "query_attempts_per_batch") >= 2
    assert _metric(r, "dropped_pairs_per_batch") > 0
    assert _metric(r, "lost_pairs_per_batch") == 0


def stalled(entry, monkeypatch):
    """The escalation stalls: its retries keep the first pass's
    capacities, and its overflow grids scan nothing, so every pair past
    the first pass's buckets is lost."""
    import torch
    from tinyknn_tpu_torch.models import ivf as program
    skewed(entry)

    def empty(grid):
        def scan_nothing(probe_sub, in_slot, dropped, *args, **kw):
            out = grid(probe_sub, in_slot, dropped, *args, **kw)
            return (*out[:4], torch.zeros_like(out[4]),
                    torch.stack([dropped, torch.zeros_like(dropped)]))
        return scan_nothing
    monkeypatch.setattr(program, "_qc_caps", lambda self, Q, n_probes, r,
                        r_tail, qc, qc0, n_active=None: (qc, qc0))
    for name in ("_overflow_grid", "_overflow_groups"):
        monkeypatch.setattr(program, name, empty(getattr(program, name)))


def one_pass(entry, monkeypatch):
    """The escalation ends after the first pass: capacities pinned at
    round 0's least (32 slots a list), with neither grid nor retry."""
    del monkeypatch
    skewed(entry)
    entry.ivf.queries_per_cluster = 32


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("fault", [stalled, one_pass],
                         ids=lambda f: f.__name__)
def test_an_escalation_that_gives_up_loses_pairs(cell, fault, monkeypatch):
    r = run(cell, trace=True, fault=lambda entry: fault(entry, monkeypatch))
    assert _metric(r, "lost_pairs_per_batch") > 0
    assert not r["correct"]
