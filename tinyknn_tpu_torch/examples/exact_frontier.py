"""Exact-engine frontier (counterpart of examples/exact_frontier.py).

On a saved GloVe-shape index switched to the exact engine (K2,
``scan_exact_csr``, on the card): per n_probes, recall10@10 through the
retrying ``query()`` path (with its drop stats) and the sustained rate
of ``query_stream`` at the margin between two stream lengths.

    python -m tinyknn_tpu_torch.examples.exact_frontier [--probes 1 2] \\
        [--index ivf_....npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import utils
from ..io import load_ivf
from . import _glove
from ._common import marginal_s, recall, stacked


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--probes", type=int, nargs="+",
                        default=[1, 2, 3, 4, 6, 10])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--reps", type=int, nargs=2, default=[4, 12])
    parser.add_argument("--scan-impl", default="exact",
                        choices=["auto", "fused", "xla", "exact"])
    parser.add_argument("--index", default=_glove.index_name())
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the same as --device cpu; "
                             "recall does not depend on the device)")
    parser.add_argument("--recall-only", action="store_true",
                        help="skip the QPS timing sweeps")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cache-dir", default=".",
                        help="where bench's truth file is read from")
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device("cpu" if args.cpu else args.device)
    utils.enable_compilation_cache()

    print("loading index...", flush=True)
    ivf = load_ivf(args.index, dev)
    t0 = time.time()
    ivf.set_scan_impl(args.scan_impl)
    utils.block(ivf.csr_vecs)
    print(f"scan_impl={args.scan_impl} derived in {time.time()-t0:.1f}s",
          flush=True)

    queries = _glove.queries()
    nq = len(queries)
    trus_file = _glove.truth_file(args.cache_dir)
    trus = np.load(trus_file) if os.path.isfile(trus_file) else None

    k = args.k
    R1, R2 = args.reps
    qb1, qb2 = stacked(queries, R1), stacked(queries, R2)

    rows = []
    for P in args.probes:
        # recall through the retrying query() path
        out, stats = ivf.query(queries, k=k, n_probes=P, with_stats=True)
        out = out.cpu().numpy()
        rec = float("nan")
        if trus is not None:
            rec = recall(trus, out, k)
        row = {"n_probes": P, "recall": rec,
               "dropped": stats["dropped_probe_pairs"],
               "total": stats["total_probe_pairs"], "marginal_s": None}
        rows.append(row)
        if args.recall_only:
            print(f"P={P:>2}: recall{k}@{k}={rec:.4f} "
                  f"dropped={stats['dropped_probe_pairs']}"
                  f"/{stats['total_probe_pairs']}", flush=True)
            continue
        # sustained QPS through query_stream, measured at the margin
        marginal = marginal_s(
            lambda qb: ivf.query_stream(qb, k=k, n_probes=P), qb1, qb2)
        row["marginal_s"] = marginal
        print(f"P={P:>2}: recall{k}@{k}={rec:.4f} "
              f"dropped={stats['dropped_probe_pairs']}"
              f"/{stats['total_probe_pairs']} "
              f"{marginal*1000:6.1f} ms/batch -> "
              f"{nq/marginal:>9,.0f} QPS sustained", flush=True)
    return {"rows": rows}


if __name__ == "__main__":
    main()
