"""Single-query / small-batch latency benchmark (counterpart of
examples/latency.py).

At the GloVe shape, on a saved index:

  * per-call wall time (the query, and the (Q, k) ids back on the host):
    what an online serving caller sees per request;
  * the stream's marginal batch time (``query_stream`` at two stream
    lengths): the device work alone once requests are pipelined.

Both 'gather' (each query gathers its probed lists; no kernel) and
'bucket' (the list-bucketed shared scan through K1, ``scan_fold_csr``)
modes are timed: where they cross is the measurement behind
``IVF.query``'s mode='auto' threshold.

    python -m tinyknn_tpu_torch.examples.latency [--batch 1 32] \\
        [--probes 10] [--index ivf_....npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import utils
from ..io import load_ivf
from . import _glove
from ._common import marginal_s


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 32])
    parser.add_argument("--probes", type=int, default=10)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--calls", type=int, default=30)
    parser.add_argument("--stream-reps", type=int, nargs=2,
                        default=[16, 48])
    parser.add_argument("--index", default=_glove.index_name())
    parser.add_argument("--scan-impl", default=None,
                        choices=["auto", "fused", "xla", "exact"])
    parser.add_argument("--device", default="cuda")
    return parser


def latency_queries(n: int = 4096):
    """n queries drawn like the dataset's (its centers, a fresh
    assignment and noise): the JAX script's recipe."""
    size, dim = _glove.SIZE, _glove.DIM
    rng = np.random.default_rng(10)
    n_comp = int((size + _glove.N_QUERIES) ** 0.5)
    centers = rng.standard_normal((n_comp, dim), dtype=np.float32)
    which = rng.integers(0, n_comp, n)
    return (centers[which] + 0.5 * rng.standard_normal(
        (n, dim), dtype=np.float32))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    utils.enable_compilation_cache()

    print("loading index...", flush=True)
    ivf = load_ivf(args.index, torch.device(args.device))
    if args.scan_impl is not None:
        ivf.set_scan_impl(args.scan_impl)

    queries = latency_queries()
    k, P = args.k, args.probes
    R1, R2 = args.stream_reps

    rows = []
    for Q in args.batch:
        for mode in ("gather", "bucket"):
            qs = queries[:Q]
            ivf.query(qs, k=k, n_probes=P, mode=mode).cpu()  # warm
            times = []
            for i in range(args.calls):
                q_i = queries[(i * Q) % 2048:(i * Q) % 2048 + Q]
                t0 = time.time()
                ivf.query(q_i, k=k, n_probes=P, mode=mode).cpu()
                times.append(time.time() - t0)
            med = float(np.median(times)) * 1000
            p90 = float(np.quantile(times, 0.9)) * 1000
            rows.append({"Q": Q, "mode": mode, "median_ms": med,
                         "p90_ms": p90})
            print(f"Q={Q:>3} mode={mode:>6}: per-call median {med:7.1f} ms "
                  f"(p90 {p90:7.1f})  [{med/Q:7.2f} ms/query]", flush=True)
        # the stream's marginal batch time (bucket mode)
        qb1 = queries[None, :Q] + (np.arange(R1, dtype=np.float32)
                                   [:, None, None] * 1e-6)
        qb2 = queries[None, :Q] + (np.arange(R2, dtype=np.float32)
                                   [:, None, None] * 1e-6)
        marg = marginal_s(lambda qb: ivf.query_stream(qb, k=k, n_probes=P),
                          qb1, qb2) * 1000
        rows.append({"Q": Q, "mode": "stream", "marginal_ms": marg})
        print(f"Q={Q:>3} bucket in-jit: {marg:7.1f} ms/batch "
              f"[{marg/Q:7.2f} ms/query]", flush=True)
    return {"rows": rows}


if __name__ == "__main__":
    main()
