"""Exact (Flat) baseline QPS for the QPS-recall plot (counterpart of
examples/flat_baseline.py).

Exact brute force is one matrix product and a top-k on the card, so any
approximate index must beat it. Recall is 1.0 by construction; this
prints the QPS to draw as a vertical line. It launches none of the
port's kernels.

    python -m tinyknn_tpu_torch.examples.flat_baseline [--device cpu]
"""

from __future__ import annotations

import argparse
import re
import time

import numpy as np

from .. import Flat, utils


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, default="random-100000-100")
    parser.add_argument("--n-queries", type=int, default=10000)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--metric", choices=["euclidean", "angular"],
                        default="angular")
    parser.add_argument("--device", default="cuda")
    return parser


def dataset(spec: str, n_queries: int):
    """(corpus, queries) for ``random-<n>-<d>`` (seed 10) or a .npy file
    (shuffled with seed 10, queries first)."""
    if match := re.match(r"random-(\d+)-(\d+)", spec):
        n, d = map(int, match.groups())
        rng = np.random.default_rng(10)
        X = rng.standard_normal((n, d), dtype=np.float32)
        qs = rng.standard_normal((n_queries, d), dtype=np.float32)
        return X, qs
    data = np.load(spec).astype(np.float32)
    np.random.seed(10)
    np.random.shuffle(data)
    return data[n_queries:], data[:n_queries]


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    X, qs = dataset(args.input, args.n_queries)
    n, d = X.shape

    index = Flat(args.metric, device=args.device)
    index.build(X)

    with utils.timer(True, "warmup/compile..."):
        ids = index.query(qs, k=args.k).cpu().numpy()

    start = time.time()
    ids = index.query(qs, k=args.k).cpu().numpy()
    elapsed = time.time() - start
    print(f"Flat exact search over n={n}, d={d}: "
          f"{args.n_queries/elapsed:,.0f} QPS (recall 1.0)")
    return {"qps": args.n_queries / elapsed, "ids": ids}


if __name__ == "__main__":
    main()
