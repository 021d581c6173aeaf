"""Full benchmark harness (counterpart of examples/bench.py).

Sweeps build_probes x n_probes on a dataset (a GloVe/SIFT .npy, or
synthetic ``random-<n>-<d>`` / ``clustered-<n>-<d>``), with ground-truth
and index caches, and reports the QPS-recall curve and its AUC. Queries
run fully batched on the card: K1 (``scan_fold_csr``), or K2
(``scan_exact_csr``) under ``--scan-impl exact``.

The caches carry the JAX script's file names, in ``--cache-dir`` (the
working directory by default), so either package reads the other's:
``trus_<name>_k_neighbours=..._num_queries=..._metric=....npy`` and
``ivf_<name>_<metric>_num_clusters=..._dims_per_block=..._build_probes=
....npz``.

    python -m tinyknn_tpu_torch.examples.bench clustered-1183514-100 \\
        --metric angular --n-queries 10000 --max-build-probes 2
"""

from __future__ import annotations

import argparse
import os.path
import re
import time

import numpy as np
import torch

from .. import IVF, FastPQ, knn_brute, utils
from ..io import load_ivf, save_ivf


def _parser():
    parser = argparse.ArgumentParser(
        description="Benchmark FastPQ and IVF on a dataset")
    parser.add_argument("filename",
                        help=".npy file (e.g. glove.twitter.27B.100d.npy), "
                             "or random-<size>-<dim> / clustered-<size>-<dim>")
    parser.add_argument("--n-queries", type=int, default=10000)
    parser.add_argument("--dims-per-block", type=int, default=2)
    parser.add_argument("--k-neighbours", type=int, default=10)
    parser.add_argument("--metric", choices=["euclidean", "angular"],
                        default="euclidean")
    parser.add_argument("--a", type=float, default=1.0,
                        help="Number of clusters will be int(a * sqrt(n))")
    parser.add_argument("--max-build-probes", type=int, default=10)
    parser.add_argument("--recall-target", type=float, default=0.9)
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--pass1-mult", type=float, default=4.0,
                        help="pass-1 rescore pool = mult * ((P+1)k+1)")
    parser.add_argument("--scan-impl", default="auto",
                        choices=["auto", "fused", "xla", "exact"],
                        help="list-scan engine; 'exact' stores raw bf16 "
                             "vector tiles and computes true distances in "
                             "the scan (thin f32 rescore only)")
    parser.add_argument("--table-dtype", default="int8",
                        choices=["int8", "bf16", "f32"],
                        help="PQ distance-table dtype")
    parser.add_argument("--rescore-rows", action="store_true",
                        help="store a CSR-ordered raw copy so the rescore "
                             "gathers by flat row (deferred id decode)")
    parser.add_argument("--sustained-reps", type=int, default=4,
                        help="Batches per call for the sustained QPS "
                             "figure (0 disables; per-call QPS is always "
                             "reported)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cache-dir", default=".",
                        help="where the truth and index caches live")
    return parser


def load_dataset(filename: str, num_queries: int):
    """(data, queries) as the JAX script splits them: the last
    ``num_queries`` rows are the queries."""
    sizes = {"xs": 10**5, "s": 3 * 10**5, "m": 10**6}
    if match := re.match(r"random-(\w+)-(\d+)", filename):
        size = sizes.get(match.group(1), None) or int(match.group(1))
        dim = int(match.group(2))
        data = np.random.default_rng(10).standard_normal(
            (size + num_queries, dim), dtype=np.float32)
    elif match := re.match(r"clustered-(\w+)-(\d+)", filename):
        size = sizes.get(match.group(1), None) or int(match.group(1))
        dim = int(match.group(2))
        # one recipe for every consumer: the truth archives were computed
        # on exactly this data
        data = np.concatenate(utils.make_clustered(size, dim, num_queries))
    else:
        data = np.load(filename).astype(np.float32)
        np.random.seed(10)
        np.random.shuffle(data)
    return data[:-num_queries], data[-num_queries:]


def auc_from(recalls, qpss) -> float:
    """Area under the QPS-recall curve for recall in [1/2, 1] (the
    reference's definition): the curve closed at (1.0, 0 QPS), started
    at its interpolated value at recall 1/2, by the trapezoid rule."""
    recalls, qpss = list(recalls) + [1.0], list(qpss) + [0.0]
    recall0 = 1 / 2
    qps0 = float(np.interp(recall0, recalls, qpss))
    i = int(np.searchsorted(recalls, recall0))
    return float(np.trapezoid([qps0] + qpss[i:], [recall0] + recalls[i:]))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    utils.enable_compilation_cache()
    dev = torch.device(args.device)
    num_queries = args.n_queries
    dims_per_block = args.dims_per_block
    k_neighbours = args.k_neighbours
    metric = args.metric
    simple_name = os.path.basename(args.filename)

    print("Loading and shuffling...")
    data, queries = load_dataset(args.filename, num_queries)
    num_points, num_dims = data.shape
    num_clusters = int(args.a * num_points**0.5)
    print(f"{num_points=}, {num_dims=}, {num_queries=}, {dims_per_block=}, "
          f"{num_clusters=}")

    trus_file = os.path.join(
        args.cache_dir,
        f"trus_{simple_name}_{k_neighbours=}_{num_queries=}_{metric=}.npy")
    if os.path.isfile(trus_file) and not args.no_cache:
        with utils.timer(True, f"Loading true neighbours from {trus_file}"):
            true_neighbours = np.load(trus_file)
        num_queries, k_neighbours = true_neighbours.shape
    else:
        with utils.timer(True, "Computing true neighbours (brute force)..."):
            true_neighbours = knn_brute(queries, data, k_neighbours,
                                        metric=metric,
                                        device=dev).cpu().numpy()
        if not args.no_cache:
            np.save(trus_file, true_neighbours)

    pq = FastPQ(dims_per_block, table_dtype=args.table_dtype, device=dev)
    ivf = IVF(metric, num_clusters, pq, scan_impl=args.scan_impl,
              rescore_rows=args.rescore_rows, device=dev)
    fit = {"done": False, "seconds": 0.0}

    def ensure_fitted():
        """Coarse k-means + PQ codebooks, once."""
        if fit["done"]:
            return
        with utils.timer(True,
                         "Fitting index (coarse KMeans + PQ codebooks)..."):
            t_fit0 = time.time()
            ivf.fit(data)
            utils.block(ivf.all_centers)
            fit["seconds"] = time.time() - t_fit0
        fit["done"] = True

    true_sets = [set(t.tolist()) for t in true_neighbours]

    def timed_ids(call):
        start = time.time()
        out = call().cpu().numpy()
        return out, time.time() - start

    builds = []
    for build_probes in range(1, args.max_build_probes):
        ivf_file = os.path.join(
            args.cache_dir, f"ivf_{simple_name}_{metric}_{num_clusters=}_"
                            f"{dims_per_block=}_{build_probes=}.npz")
        if os.path.isfile(ivf_file) and not args.no_cache:
            with utils.timer(True, f"Loading built index from {ivf_file}"):
                ivf = load_ivf(ivf_file, dev)
            if ivf.scan_impl != args.scan_impl:
                with utils.timer(True, "Switching scan engine..."):
                    ivf.set_scan_impl(args.scan_impl)
            # tables are built per query from the codebooks, so the dtype
            # flips freely on a cached index
            ivf.pq.table_dtype = args.table_dtype
            if args.rescore_rows:
                with utils.timer(True, "Building CSR-ordered raw rows..."):
                    ivf.set_rescore_rows(True)
            fit["done"], build_time = True, 0.0
        else:
            ensure_fitted()
            with utils.timer(True,
                             f"Adding each point to {build_probes} lists..."):
                t0 = time.time()
                ivf.build(data, n_probes=build_probes)
                utils.block(ivf.csr_codes)
                build_time = time.time() - t0
            if not args.no_cache:
                with utils.timer(True, f"Caching built index to {ivf_file}"):
                    save_ivf(ivf_file, ivf)
        print(f"[build] fit={fit['seconds']:.1f}s build={build_time:.1f}s")

        print("Querying (batched)")
        recall = 0.0
        n_probes = 1
        points, qpss, recalls = [], [], []
        while recall < args.recall_target and n_probes <= ivf.n_clusters:
            # pass1_mult=0 -> library default (in exact mode pass_1 only
            # widens the fold against slot collisions)
            p1 = (int(args.pass1_mult * ((n_probes + 1) * k_neighbours + 1))
                  or None)

            def query():
                return ivf.query(queries, k=k_neighbours, n_probes=n_probes,
                                 pass_1=p1)

            guesses, _ = timed_ids(query)                     # warm
            elapsed = float("inf")
            for _ in range(2):                                # best of 2
                guesses, el = timed_ids(query)
                elapsed = min(elapsed, el)
            qps = num_queries / elapsed
            found = sum(len(true_sets[i] & set(g.tolist()))
                        for i, g in enumerate(guesses))
            recall = found / k_neighbours / num_queries
            sustained, qps_s = "", None
            if args.sustained_reps:
                # steady-state rate: R batches per call, so the per-call
                # round trip is amortized, as a pipelined deployment sees
                R = args.sustained_reps
                jitter = (np.arange(R, dtype=np.float32)[:, None, None]
                          * 1e-6)
                qb = queries[None] + jitter

                def stream():
                    return ivf.query_stream(qb, k=k_neighbours,
                                            n_probes=n_probes, pass_1=p1)

                timed_ids(stream)                             # warm
                el_s = min(timed_ids(stream)[1] for _ in range(2))
                qps_s = R * num_queries / el_s
                sustained = f"  sustained={qps_s:,.0f}"
                qps = max(qps, qps_s)
            qpss.append(qps)
            recalls.append(recall)
            points.append({"n_probes": n_probes, "pass_1": p1,
                           "recall": recall, "qps": qps,
                           "per_call_qps": num_queries / elapsed,
                           "sustained_qps": qps_s})
            print(f"Probing {n_probes:>3}/{ivf.n_clusters}: "
                  f"recall{k_neighbours}@{k_neighbours}={recall:.5f}  "
                  f"QPS={qps:,.2f}{sustained}")
            n_probes += max(int(n_probes**0.5), 1)

        auc = auc_from(recalls, qpss)
        print(f"Area under the curve from {1 / 2} to 1: {auc:.1f}")
        builds.append({"build_probes": build_probes, "points": points,
                       "auc": auc, "fit_s": fit["seconds"],
                       "build_s": build_time})
    return {"num_clusters": num_clusters, "builds": builds}


if __name__ == "__main__":
    main()
