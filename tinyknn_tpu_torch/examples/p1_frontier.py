"""P=1 operating-point frontier (counterpart of examples/p1_frontier.py).

At P=1 the list scan is a small part of a batch: the pool selection and
the exact rescore dominate, and both scale with the pass-1 width. This
sweeps {pass_1} x {fold_mult} x {rescore_rows} x {table_dtype} at P=1
on the GloVe-shape index, reporting the stream's marginal batch time
and recall10@10: the data for picking the fastest point at a recall
floor (K1, ``scan_fold_csr``, on the card).

    python -m tinyknn_tpu_torch.examples.p1_frontier [--pass1 21 84] \\
        [--index ivf_....npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import utils
from ..io import load_ivf
from . import _glove
from ._common import marginal_s, recall, stacked


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--pass1", type=int, nargs="+",
                        default=[17, 21, 42, 84])
    # fold_mult is a no-op at P=1 (the round-0 fold covers the nearest
    # list fully), so the default grid pins it
    parser.add_argument("--mults", type=int, nargs="+", default=[8])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--probes", type=int, default=1)
    parser.add_argument("--reps", type=int, nargs=2, default=[4, 12])
    parser.add_argument("--rescore-rows", type=int, nargs="+",
                        default=[0, 1])
    parser.add_argument("--table-dtypes", nargs="+", default=["int8"],
                        choices=["int8", "bf16"])
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

    queries = _glove.queries()
    nq = len(queries)
    trus_file = _glove.truth_file(args.cache_dir)
    trus = np.load(trus_file) if os.path.isfile(trus_file) else None

    k, P = args.k, args.probes
    R1, R2 = args.reps
    qb1, qb2 = stacked(queries, R1), stacked(queries, R2)

    rows = []
    for td in args.table_dtypes:
        ivf.pq.table_dtype = td
        for rr in args.rescore_rows:
            ivf.set_rescore_rows(bool(rr))
            for fm in args.mults:
                ivf.fold_mult = fm
                for p1 in args.pass1:
                    def run(qb):
                        return ivf.query_stream(qb, k=k, n_probes=P,
                                                pass_1=p1)

                    out = run(qb1).cpu().numpy()
                    marginal = marginal_s(run, qb1, qb2)
                    line = (f"tables={td} rr={rr} fold_mult={fm:>2} "
                            f"P={P} pass_1={p1:>3}: "
                            f"{marginal*1000:6.1f} ms/batch -> "
                            f"{nq/marginal:>9,.0f} QPS")
                    row = {"table_dtype": td, "rescore_rows": rr,
                           "fold_mult": fm, "pass_1": p1,
                           "marginal_s": marginal, "recall": None}
                    if trus is not None:
                        row["recall"] = recall(trus, out[0], k)
                        line += f"  recall{k}@{k}={row['recall']:.4f}"
                    rows.append(row)
                    print(line, flush=True)
    return {"rows": rows}


if __name__ == "__main__":
    main()
