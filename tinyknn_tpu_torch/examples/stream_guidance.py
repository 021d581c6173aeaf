"""Stream capacity guidance table (counterpart of
examples/stream_guidance.py).

``query_stream`` sizes its bucket capacities itself by default
(``adaptive_qc``: a one-time per-shape load pre-pass plus a drop
counter); pinning ``queries_per_cluster`` turns that off for a fixed
capacity. On the GloVe-shape index with its clustered queries, this
measures what the adaptive default and each pinned multiple of the
heuristic cost and buy: dropped (query, probe) pairs, recall10@10 and
the marginal batch time (K1, ``scan_fold_csr``, on the card).

    python -m tinyknn_tpu_torch.examples.stream_guidance [--probes 3 10] \\
        [--index ivf_....npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import utils
from ..io import load_ivf
from ..models.ivf import default_qc0
from . import _glove
from ._common import marginal_s, recall, stacked


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--probes", type=int, nargs="+", default=[3, 10])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--mult", type=float, default=4.0)
    parser.add_argument("--qc-mults", type=float, nargs="+",
                        default=[1.0, 2.0, 4.0])
    parser.add_argument("--reps", type=int, nargs=2, default=[4, 12])
    parser.add_argument("--scan-impl", default=None,
                        choices=["auto", "fused", "xla", "exact"])
    parser.add_argument("--index", default=_glove.index_name())
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cache-dir", default=".",
                        help="where bench's truth file is read from")
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    utils.enable_compilation_cache()

    print("loading index...", flush=True)
    ivf = load_ivf(args.index, torch.device(args.device))
    if args.scan_impl is not None:
        ivf.set_scan_impl(args.scan_impl)

    queries = _glove.queries()
    nq = len(queries)
    trus_file = _glove.truth_file(args.cache_dir)
    trus = np.load(trus_file) if os.path.isfile(trus_file) else None

    k = args.k
    R1, R2 = args.reps
    n_active = int(ivf.active_centers.shape[0])
    qb1, qb2 = stacked(queries, R1), stacked(queries, R2)

    rows = []
    for P in args.probes:
        p1 = int(args.mult * ((P + 1) * k + 1)) or None
        # the same mean-load heuristic IVF.query starts from
        qc_heur = max(8, 8 * ((5 * nq * P // (2 * n_active)) // 8 + 1))
        qc0_heur = default_qc0(nq, n_active)
        for m in ["auto"] + args.qc_mults:
            if m == "auto":
                # the adaptive default: a load pre-pass sizes the
                # capacity (once per shape), the drop counter guards drift
                ivf.queries_per_cluster = None
                ivf._stream_qc_floors = {}
            else:
                ivf.queries_per_cluster = int(max(qc_heur, qc0_heur) * m
                                              + 7) // 8 * 8
            out, stats = ivf.query_stream(qb1, k=k, n_probes=P, pass_1=p1,
                                          with_stats=True)
            out = out.cpu().numpy()
            marginal = marginal_s(
                lambda qb: ivf.query_stream(qb, k=k, n_probes=P, pass_1=p1),
                qb1, qb2)
            dropped = stats["dropped_probe_pairs"]
            total = stats["total_probe_pairs"]
            qc_lbl = ("auto" if m == "auto"
                      else f"{ivf.queries_per_cluster:>4} ({m:.0f}x heur)")
            line = (f"P={P:>2} qc={qc_lbl}: dropped {dropped}/{total} "
                    f"({100*dropped/max(total,1):.3f}%)  "
                    f"{marginal*1000:6.1f} ms/batch -> "
                    f"{nq/marginal:>9,.0f} QPS")
            row = {"n_probes": P, "qc": m if m == "auto"
                   else ivf.queries_per_cluster, "dropped": dropped,
                   "total": total, "marginal_s": marginal, "recall": None}
            if trus is not None:
                row["recall"] = recall(trus, out[0], k)
                line += f"  recall{k}@{k}={row['recall']:.4f}"
            rows.append(row)
            print(line, flush=True)
        ivf.queries_per_cluster = None
    return {"rows": rows}


if __name__ == "__main__":
    main()
