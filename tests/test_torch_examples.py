"""The port's examples (``tinyknn_tpu_torch.examples``), each through its
``main`` at a toy size with ``--device cpu``, against the JAX package.

An example that fits its own index must give the numbers of the port's
library calls on the same seed, and recalls within 0.05 of the JAX
package's (the two packages draw different k-means centres). An example
that reads an archive gets one written by ``tinyknn_tpu.io.save_ivf``
from a JAX-built toy index (with the GloVe-shape constants of
``examples._glove`` cut to the toy dataset): its recall must equal the
JAX package's query on the same archive and queries.
"""

import runpy
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tinyknn_tpu import IVF as JaxIVF
from tinyknn_tpu import FastPQ as JaxFastPQ
from tinyknn_tpu import Flat as JaxFlat
from tinyknn_tpu import knn_brute as jax_knn_brute
from tinyknn_tpu.io import load_ivf as jax_load_ivf
from tinyknn_tpu.io import save_ivf as jax_save_ivf
from tinyknn_tpu_torch import IVF, FastPQ, knn_brute, make_clustered
from tinyknn_tpu_torch.examples import (
    _glove,
    bench,
    coverage_ceiling,
    example,
    exact_frontier,
    flat_baseline,
    ivf_example,
    latency,
    multiprobes,
    p1_frontier,
    serving_pipeline,
    sift_convert,
    stream_guidance,
)

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
FIT_SLACK = 0.05
# the toy dataset the archive examples read: make_clustered(SIZE, DIM,
# N_QUERIES), int(sqrt(SIZE)) clusters, as bench names it
TOY = dict(SIZE=3000, DIM=16, N_QUERIES=200, N_CLUSTERS=54)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The toy sizes here are small ops in Python loops: one torch thread
    runs them as fast and keeps this file from crowding the other test
    workers' cores. The setting is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recall(ids, truth, k=10):
    return float(np.mean([len(set(a.tolist()) & set(t.tolist())) / k
                          for a, t in zip(np.asarray(ids), truth)]))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """JAX-built archives at build_probes 1 and 2 and the ground truth,
    in one directory under the names bench gives them."""
    mp = pytest.MonkeyPatch()
    for name, value in TOY.items():
        mp.setattr(_glove, name, value)
    cache = tmp_path_factory.mktemp("toy")
    X, qs = make_clustered(TOY["SIZE"], TOY["DIM"], TOY["N_QUERIES"])
    jax = {}
    for bp in (1, 2):
        jax[bp] = JaxIVF("angular", TOY["N_CLUSTERS"], JaxFastPQ(2))
        jax[bp].fit(X).build(X, n_probes=bp)
        jax_save_ivf(cache / _glove.index_name(bp), jax[bp])
    truth = knn_brute(qs, X, 10, metric="angular", device="cpu").numpy()
    np.save(_glove.truth_file(str(cache)), truth)
    yield dict(cache=cache, queries=qs, truth=truth, jax=jax,
               index=[str(cache / _glove.index_name(bp)) for bp in (0, 1, 2)])
    mp.undo()


# ------------------------------------------------- examples that fit


def test_example_matches_library_and_jax():
    argv = ["--input", "random-3000-32", "--k", "200", *CPU]
    np.random.seed(4)
    got = example.main(argv)
    np.random.seed(4)
    X = np.random.randn(3000, 32).astype(np.float32)
    qs = np.random.randn(200, 32).astype(np.float32)
    pq = FastPQ(2, rotate_dim=None, device="cpu").fit(X)
    est = pq.distance_table(qs).estimate_distances(pq.transform(X))
    trus = knn_brute(qs, X, 1, device="cpu")[:, 0]
    places = example.rank_stats(est, trus)[0].numpy()
    assert got["median"] == float(np.median(places))
    assert got["quantiles"][0.9] == float(np.quantile(places, 0.9))
    assert got["total"] == 200 * 3000

    jpq = JaxFastPQ(2, rotate_dim=None).fit(X)
    jest = np.asarray(jpq.distance_table(qs).estimate_distances(
        jpq.transform(X)))
    jtrus = np.asarray(jax_knn_brute(qs, X, k=1))[:, 0]
    jplaces = example.rank_stats(torch.from_numpy(jest.copy()),
                                 torch.from_numpy(jtrus.astype(np.int64)))[
        0].numpy()
    # the share of queries whose true neighbour ranks in the top 10
    assert abs(np.mean(places < 10) - np.mean(jplaces < 10)) <= FIT_SLACK


def test_ivf_example_matches_library_and_jax():
    n, d, nq, C, bp, P = 2000, 16, 200, 20, 2, 2
    got = ivf_example.main(["--n", str(n), "--d", str(d), "--n-queries",
                            str(nq), "--n-clusters", str(C),
                            "--max-probes", str(P), *CPU])
    np.random.seed(10)
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = knn_brute(qs, X, 10, device="cpu").numpy()
    ivf = IVF("euclidean", C, FastPQ(2, device="cpu"), device="cpu")
    ivf.fit(X).build(X, n_probes=bp)
    jivf = JaxIVF("euclidean", C, JaxFastPQ(2)).fit(X).build(X, n_probes=bp)
    assert [r["n_probes"] for r in got["rows"]] == [1, 2]
    for row in got["rows"]:
        p = row["n_probes"]
        assert row["recall"] == _recall(ivf.query(qs, k=10, n_probes=p),
                                        trus)
        jax_rec = _recall(jivf.query(qs, k=10, n_probes=p), trus)
        assert abs(row["recall"] - jax_rec) <= FIT_SLACK, (p, jax_rec)


def test_multiprobes_matches_library_and_jax():
    n, d, nq = 1600, 16, 150
    got = multiprobes.main(["--n", str(n), "--d", str(d), "--n-queries",
                            str(nq), "--max-probes", "2", *CPU])["recall"]
    np.random.seed(10)
    X = np.random.randn(n, d).astype(np.float32)
    qs = np.random.randn(nq, d).astype(np.float32)
    trus = knn_brute(qs, X, 10, device="cpu").numpy()
    C = int(n ** 0.5)
    assert np.shape(got) == (2, 2)
    for bp in (1, 2):
        ivf = IVF("euclidean", C, FastPQ(2, device="cpu"), device="cpu")
        ivf.fit(X).build(X, n_probes=bp)
        for qp in (1, 2):
            assert got[bp - 1][qp - 1] == _recall(
                ivf.query(qs, k=10, n_probes=qp), trus)
    # the JAX package's row at build_probes=2 (ivf_example holds P=1 and 2
    # at build_probes=2 too; one JAX fit keeps the test cheap)
    jivf = JaxIVF("euclidean", C, JaxFastPQ(2)).fit(X).build(X, n_probes=2)
    for qp in (1, 2):
        jax_rec = _recall(jivf.query(qs, k=10, n_probes=qp), trus)
        assert abs(got[1][qp - 1] - jax_rec) <= FIT_SLACK


def test_flat_baseline_is_exact(capsys):
    got = flat_baseline.main(["--input", "random-4000-24", "--n-queries",
                              "100", *CPU])
    assert "(recall 1.0)" in capsys.readouterr().out
    X, qs = flat_baseline.dataset("random-4000-24", 100)
    want = np.asarray(JaxFlat("angular").build(X).query(qs, k=10))
    assert _recall(got["ids"], want) == 1.0


def test_bench_fits_like_the_library_and_jax(tmp_path):
    """No cache: bench fits, builds, caches and sweeps; the recall at
    each point is the library's on the same data, and within 0.05 of
    the JAX package's; the caches it wrote are read back by a second
    run with the same numbers."""
    argv = ["random-2500-16", "--n-queries", "100", "--max-build-probes",
            "2", "--recall-target", "0.2", "--sustained-reps", "2",
            "--cache-dir", str(tmp_path), *CPU]
    got = bench.main(argv)
    data, queries = bench.load_dataset("random-2500-16", 100)
    C = int(2500 ** 0.5)
    assert got["num_clusters"] == C
    truth = knn_brute(queries, data, 10, device="cpu").numpy()
    ivf = IVF("euclidean", C, FastPQ(2, device="cpu"), device="cpu")
    ivf.fit(data).build(data, n_probes=1)
    jivf = JaxIVF("euclidean", C, JaxFastPQ(2)).fit(data).build(
        data, n_probes=1)
    points = got["builds"][0]["points"]
    assert points and points[-1]["recall"] >= 0.2
    for pt in points:
        kw = dict(k=10, n_probes=pt["n_probes"], pass_1=pt["pass_1"])
        assert pt["recall"] == pytest.approx(
            _recall(ivf.query(queries, **kw), truth), abs=1e-12)
        jax_rec = _recall(jivf.query(queries, **kw), truth)
        assert abs(pt["recall"] - jax_rec) <= FIT_SLACK
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [
        "ivf_random-2500-16_euclidean_num_clusters=50_dims_per_block=2_"
        "build_probes=1.npz",
        "trus_random-2500-16_k_neighbours=10_num_queries=100_"
        "metric='euclidean'.npy"]
    again = bench.main(argv)["builds"][0]["points"]
    assert [p["recall"] for p in again] == [p["recall"] for p in points]


# ------------------------------------------- examples on an archive


def test_bench_reads_the_jax_caches(toy):
    got = bench.main(["clustered-3000-16", "--metric", "angular",
                      "--n-queries", "200", "--max-build-probes", "2",
                      "--recall-target", "0.99", "--sustained-reps", "2",
                      "--cache-dir", str(toy["cache"]), *CPU])
    jivf = jax_load_ivf(toy["index"][1])
    build, = got["builds"]
    assert build["fit_s"] == build["build_s"] == 0.0      # read, not built
    for pt in build["points"]:
        ids = jivf.query(toy["queries"], k=10, n_probes=pt["n_probes"],
                         pass_1=pt["pass_1"])
        assert pt["recall"] == pytest.approx(_recall(ids, toy["truth"]),
                                             abs=1e-12)


def test_p1_frontier_matches_jax(toy):
    got = p1_frontier.main(["--pass1", "21", "84", "--rescore-rows", "0",
                            "1", "--reps", "1", "2", "--index",
                            toy["index"][1], "--cache-dir",
                            str(toy["cache"]), *CPU])["rows"]
    jivf = jax_load_ivf(toy["index"][1])
    want = {p1: _recall(jivf.query(toy["queries"], k=10, n_probes=1,
                                   pass_1=p1), toy["truth"])
            for p1 in (21, 84)}
    assert len(got) == 4
    for row in got:
        assert row["recall"] == want[row["pass_1"]]


def test_stream_guidance_matches_jax(toy):
    got = stream_guidance.main(["--probes", "2", "--qc-mults", "1",
                                "--reps", "1", "2", "--index",
                                toy["index"][1], "--cache-dir",
                                str(toy["cache"]), *CPU])["rows"]
    auto = got[0]
    assert auto["qc"] == "auto" and auto["dropped"] == 0
    jivf = jax_load_ivf(toy["index"][1])
    ids = jivf.query(toy["queries"], k=10, n_probes=2, pass_1=124)
    assert auto["recall"] == _recall(ids, toy["truth"])


def test_exact_frontier_matches_jax(toy):
    got = exact_frontier.main(["--probes", "1", "2", "--reps", "1", "2",
                               "--index", toy["index"][2], "--cache-dir",
                               str(toy["cache"]), *CPU])["rows"]
    jivf = jax_load_ivf(toy["index"][2])
    jivf.set_scan_impl("exact")
    for row in got:
        ids = jivf.query(toy["queries"], k=10, n_probes=row["n_probes"])
        assert row["recall"] == _recall(ids, toy["truth"])
        assert row["dropped"] == 0 and row["marginal_s"] is not None
    only = exact_frontier.main(["--probes", "1", "--recall-only", "--cpu",
                                "--index", toy["index"][2], "--cache-dir",
                                str(toy["cache"])])["rows"]
    assert only[0]["recall"] == got[0]["recall"]
    assert only[0]["marginal_s"] is None


def test_latency_runs_both_modes(toy):
    rows = latency.main(["--batch", "1", "8", "--calls", "3",
                         "--stream-reps", "1", "2", "--index",
                         toy["index"][1], *CPU])["rows"]
    assert [(r["Q"], r["mode"]) for r in rows] == [
        (1, "gather"), (1, "bucket"), (1, "stream"),
        (8, "gather"), (8, "bucket"), (8, "stream")]
    assert all(r.get("median_ms", 1.0) > 0 for r in rows)


def test_serving_pipeline_on_an_archive(toy):
    got = serving_pipeline.main(["--glove", "--reps", "1", "2",
                                 "--cache-dir", str(toy["cache"]), *CPU])
    assert got["pooled_equal"] and got["n_queries"] == TOY["N_QUERIES"]


def test_coverage_ceiling_prints_the_jax_lines(toy, capsys, monkeypatch):
    argv = ["--index", toy["index"][2], "--probes", "1", "2",
            "--n-queries", str(TOY["N_QUERIES"])]
    got = coverage_ceiling.main(argv + ["--cache-dir", str(toy["cache"])])
    port_out = capsys.readouterr().out
    monkeypatch.chdir(toy["cache"])            # the JAX script reads here
    monkeypatch.setattr("sys.argv", ["coverage_ceiling.py", *argv])
    runpy.run_path(str(ROOT / "examples" / "coverage_ceiling.py"))
    assert capsys.readouterr().out == port_out
    assert [r["n_probes"] for r in got["rows"]] == [1, 2]
    assert all(r["membership"] >= r["recall"] - 1e-12 for r in got["rows"])


# ------------------------------------------------------- the rest


def test_sift_convert(tmp_path):
    mat = np.random.default_rng(1).standard_normal((20, 8)).astype(
        np.float32)
    rec = np.empty((20, 9), np.int32)
    rec[:, 0] = 8
    rec[:, 1:] = mat.view(np.int32)
    src = tmp_path / "sift_base.fvecs"
    rec.tofile(src)
    got = sift_convert.main([str(src), str(tmp_path / "a.npy")])
    assert got == {"shape": (20, 8), "dtype": "float32"}
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), mat)
    with tarfile.open(tmp_path / "sift.tar.gz", "w:gz") as tar:
        tar.add(src, arcname="sift/sift_base.fvecs")
    sift_convert.main([str(tmp_path / "sift.tar.gz"),
                       str(tmp_path / "b.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"), mat)


@pytest.mark.parametrize("module, argv", [
    (example, ["--input", "random-500-8", "--k", "5"]),
    (ivf_example, ["--n", "300", "--n-queries", "5"]),
    (multiprobes, ["--n", "300", "--n-queries", "5"]),
    (flat_baseline, ["--input", "random-300-8", "--n-queries", "5"]),
    (bench, ["random-300-8", "--n-queries", "5", "--no-cache"]),
])
def test_examples_default_to_the_card(module, argv):
    """Without --device an example targets the card: on a machine
    without CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        module.main(argv)

