"""FastPQ-accelerated exact kNN demo (counterpart of examples/example.py).

Fits a 4-bit PQ, runs the full-scan distance estimate for a batch of
queries in one call (K3, ``estimate_scan_tiled``, on the card), and
reports the rank distribution of the true nearest neighbor plus QPS.

    python -m tinyknn_tpu_torch.examples.example [--device cpu]
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from .. import FastPQ, knn_brute, utils


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, default="random-16000-128",
                        help="Input .npy file or random-n-d")
    parser.add_argument("--k", type=int, default=1000,
                        help="Number of queries")
    parser.add_argument("--dpb", type=int, default=2,
                        help="Dimensions per block")
    parser.add_argument("--unsigned", action="store_true",
                        help="Use unsigned distance quantization")
    parser.add_argument("--rotate-dim", type=int, default=None,
                        help="Random-rotation projection dim (default: off)")
    parser.add_argument("--device", default="cuda")
    return parser


def rank_stats(est: torch.Tensor, trus: torch.Tensor):
    """Mid-rank of each query's true nearest neighbour among its
    estimates, and how many estimates sit at the matrix's maximum."""
    tru_vals = torch.gather(est, 1, trus[:, None])
    less = (est < tru_vals).sum(1)
    ties = (est == tru_vals).sum(1) - 1
    return less + ties // 2, int((est == est.max()).sum())


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    if match := re.match(r"random-(\d+)-(\d+)", args.input):
        n, d = map(int, match.groups())
        with utils.timer(True, f"Sampling {n=} vectors of dimension {d=}"):
            X = np.random.randn(n, d).astype(np.float32)
            qs = np.random.randn(args.k, d).astype(np.float32)
    else:
        with utils.timer(True, f"Loading and shuffling {args.input}"):
            data = np.load(args.input).astype(np.float32)
            np.random.seed(10)
            np.random.shuffle(data)
            qs = data[:args.k]
            X = data[args.k:]
            n, d = X.shape

    k, dpb, signed = args.k, args.dpb, not args.unsigned
    print(f"{n=}, {d=}, queries={k}, dims_per_block={dpb}")

    with utils.timer(True, "Computing true neighbours"):
        trus = knn_brute(qs, X, k=1, device=dev)[:, 0]

    with utils.timer(True, "Fitting PQ"):
        pq = FastPQ(dims_per_block=dpb, rotate_dim=args.rotate_dim,
                    device=dev)
        pq.fit(X[:10**5])

    with utils.timer(True, "Transforming data"):
        data = pq.transform(X)
        utils.block(data.packed)

    print("Querying (batched: one dispatch for all queries)")
    # warm up (builds the kernel on its first launch)
    dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
    est = dtable.estimate_distances(data)
    utils.block(est)

    start = time.time()
    dtable = pq.distance_table(qs) if signed else pq.udistance_table(qs)
    utils.block(dtable.tables)
    t1 = time.time() - start

    start = time.time()
    est = dtable.estimate_distances(data)
    utils.block(est)
    t2 = time.time() - start

    places, sat_up = rank_stats(est, trus)
    places = places.cpu().numpy()
    total = est.numel()

    print()
    print("Median place of true nearest neighbor:", np.median(places))
    quantiles = {}
    for q in [0.5, 0.75, 0.9, 0.99]:
        quantiles[q] = float(np.quantile(places, q))
        print(f"{q:.2%} quantile:", np.quantile(places, q))
    print("Queries/second:", k / (t1 + t2))
    print()
    print("Total time spent on preprocess:", t1)
    print("Total time spent on search:", t2)
    print(f"Values at estimate max (int32 accumulation never saturates): "
          f"{sat_up}/{total}")
    return {"median": float(np.median(places)), "quantiles": quantiles,
            "qps": k / (t1 + t2), "preprocess_s": t1, "search_s": t2,
            "at_max": sat_up, "total": total}


if __name__ == "__main__":
    main()
