"""Configurations whose vectors FastPQ projects (a raw dimension other
than 100): the judge follows the projection, so sound runs come out
correct with every answer and code equal to the reference's, and a
program that projects otherwise, or not at all, does not."""

import pytest
import torch

from gpubench import control
from gpubench.reference import ivf as ref
from gpubench.tests.smallrun import (BENCH, cells, override, pq_cells,
                                     quiet, run)

# ANN-Benchmarks sift-128-euclidean's width and metric, the same width
# angular, and deep-image-96's width: each projected to 64
WIDE = {"sift128-euclidean": {"dataset": {"dim": 128, "metric": "euclidean"}},
        "d128-angular": {"dataset": {"dim": 128, "metric": "angular"}},
        "deep96-angular": {"dataset": {"dim": 96, "metric": "angular"}}}
SIFT = WIDE["sift128-euclidean"]


def _off(r, name):
    return r["checks"][name]["value"]


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("shape", sorted(WIDE))
def test_a_projected_sound_run_is_correct(cell, shape):
    r = run(cell, extra=WIDE[shape])
    assert r["correct"], r["checks"]
    assert _off(r, "answers_off") == 0.0 and _off(r, "codes_off") == 0.0


def other_seed(entry):
    """FastPQ seeded otherwise: its projection (and its codebooks'
    k-means) drawn from seed 1, not from the configuration's seed."""
    entry.ivf.pq.seed += 1


def unprojected_codes(entry):
    """The codes encoded from the first coded-width raw columns, as if
    FastPQ drew no projection."""
    pq = entry.ivf.pq
    transform = pq.transform

    def call(data, verbose=False):
        R, pq.R = pq.R, None
        try:
            return transform(data[:, :R.shape[0]], verbose)
        finally:
            pq.R = R
    pq.transform = call


@pytest.mark.parametrize("cell", pq_cells())
@pytest.mark.parametrize("fault", [other_seed, unprojected_codes],
                         ids=lambda f: f.__name__)
def test_a_projection_off_the_recipe_is_not_correct(cell, fault):
    r = run(cell, fault=fault, extra=SIFT)
    assert not r["correct"]
    assert _off(r, "codes_off") > r["checks"]["codes_off"]["limit"]


@pytest.mark.parametrize("cell", pq_cells())
def test_tables_of_unprojected_queries_are_not_correct(cell, monkeypatch):
    from tinyknn_tpu_torch.models import ivf as program
    scan_tables = program._scan_tables

    def cropped(q, center_blocks, R, *args):
        if R is not None:
            q = q[:, :R.shape[0]]
        return scan_tables(q, center_blocks, None, *args)
    monkeypatch.setattr(program, "_scan_tables", cropped)
    r = run(cell, extra=SIFT)
    assert not r["correct"]
    assert _off(r, "answers_off") > r["checks"]["answers_off"]["limit"]
    assert _off(r, "codes_off") == 0.0


@pytest.mark.parametrize("cell", cells())
def test_the_projected_control_is_not_correct(cell):
    (res,) = control.run(cell, [7], bench_file=BENCH, device="cpu",
                         override=override(cell, SIFT), log=quiet)
    _, numbers, correct, _ = res
    assert not correct
    assert numbers["answers_off"] > 0.02


@pytest.mark.parametrize("d, rotate_dim", [(128, 64), (96, 64), (40, 64),
                                           (128, 30), (100, 64), (128, None)])
def test_the_reference_draws_fastpqs_projection(d, rotate_dim):
    from tinyknn_tpu_torch import FastPQ
    x = torch.randn(512, d, generator=torch.Generator().manual_seed(d))
    pq = FastPQ(2, rotate_dim=rotate_dim, kmeans_iters=1, device="cpu").fit(x)
    R = ref.projection(d, 2, rotate_dim, pq.seed, "cpu")
    if pq.R is None:
        assert R is None
    else:
        assert torch.equal(R, pq.R)
