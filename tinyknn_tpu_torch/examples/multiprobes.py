"""Recall grid over build_probes x query probes (counterpart of
examples/multiprobes.py): one index per build_probes, each queried
through K1 (``scan_fold_csr``) on the card.

    python -m tinyknn_tpu_torch.examples.multiprobes [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import IVF, FastPQ, knn_brute
from ._common import recall


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20000)
    parser.add_argument("--d", type=int, default=64)
    parser.add_argument("--n-queries", type=int, default=500)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--metric", choices=["euclidean", "angular"],
                        default="euclidean")
    parser.add_argument("--max-probes", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    np.random.seed(10)
    X = np.random.randn(args.n, args.d).astype(np.float32)
    qs = np.random.randn(args.n_queries, args.d).astype(np.float32)
    trus = knn_brute(qs, X, k=args.k, metric=args.metric,
                     device=dev).cpu().numpy()

    print("build\\query  " + " ".join(f"{qp:>7}" for qp in
                                      range(1, args.max_probes + 1)))
    grid = []
    for bp in range(1, args.max_probes + 1):
        ivf = IVF(args.metric, int(args.n ** 0.5), FastPQ(2, device=dev),
                  device=dev)
        ivf.fit(X).build(X, n_probes=bp)
        row = []
        for qp in range(1, args.max_probes + 1):
            guesses = ivf.query(qs, k=args.k, n_probes=qp).cpu().numpy()
            row.append(recall(trus, guesses, args.k))
        grid.append(row)
        print(f"{bp:>11}  " + " ".join(f"{r:>7.4f}" for r in row))
    return {"recall": grid}


if __name__ == "__main__":
    main()
