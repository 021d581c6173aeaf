"""IVF recall/QPS sweep over n_probes (counterpart of
examples/ivf_example.py): the list scan K1 (``scan_fold_csr``) on the
card, its tail rounds at n_probes > 1, and the dedup of build_probes=2.

    python -m tinyknn_tpu_torch.examples.ivf_example [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import IVF, FastPQ, knn_brute, utils
from ._common import recall


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=10000)
    parser.add_argument("--d", type=int, default=128)
    parser.add_argument("--n-queries", type=int, default=1000)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--metric", choices=["euclidean", "angular"],
                        default="euclidean")
    parser.add_argument("--n-clusters", type=int, default=100)
    parser.add_argument("--build-probes", type=int, default=2)
    parser.add_argument("--max-probes", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    np.random.seed(10)
    X = np.random.randn(args.n, args.d).astype(np.float32)
    qs = np.random.randn(args.n_queries, args.d).astype(np.float32)

    with utils.timer(True, "Computing ground truth..."):
        trus = knn_brute(qs, X, k=args.k, metric=args.metric,
                         device=dev).cpu().numpy()

    with utils.timer(True, "Building index..."):
        ivf = IVF(args.metric, args.n_clusters, FastPQ(2, device=dev),
                  device=dev)
        ivf.fit(X).build(X, n_probes=args.build_probes)

    print(f"\n{'n_probes':>8} {'recall@10':>10} {'QPS':>12}")
    rows = []
    for n_probes in range(1, args.max_probes + 1):
        ivf.query(qs, k=args.k, n_probes=n_probes).cpu()  # warm
        start = time.time()
        guesses = ivf.query(qs, k=args.k, n_probes=n_probes).cpu().numpy()
        elapsed = time.time() - start
        rec = recall(trus, guesses, args.k)
        print(f"{n_probes:>8} {rec:>10.4f} {args.n_queries/elapsed:>12.0f}")
        rows.append({"n_probes": n_probes, "recall": rec,
                     "qps": args.n_queries / elapsed})
    return {"rows": rows}


if __name__ == "__main__":
    main()
