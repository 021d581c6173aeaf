"""Pipelined serving with ``query_stream(device_out=True)`` (counterpart
of examples/serving_pipeline.py).

The ids of a retrieval are usually not the product: they feed a next
stage (fetch the neighbours' embeddings, pool them, score a candidate
set). This runs that two-stage pipeline on the device:

    stage 1: IVF top-k ids for an (R, Q, d) stream   (device_out=True)
    stage 2: gather the neighbours' stored vectors and mean-pool them
             (a kNN "read head": the (R, Q, k) ids never reach the
             host; only the final (Q, d) pooled block does)

and times it against the same pipeline with a host hop between the
stages (ids downloaded, then uploaded again for the gather).

Small shapes by default; ``--glove`` reads the GloVe-shape archive that
``bench`` caches (in ``--cache-dir``).

    python -m tinyknn_tpu_torch.examples.serving_pipeline [--glove] \\
        [--reps 2 7] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import IVF, FastPQ, utils
from ..io import load_ivf
from . import _glove


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--glove", action="store_true",
                        help="GloVe-scale cached archive")
    parser.add_argument("--reps", type=int, nargs=2, default=[2, 7])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--n-probes", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cache-dir", default=".",
                        help="where --glove finds bench's archive")
    return parser


def read_head(ids: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Mean-pool the k neighbours' vectors per query: (R, Q, k) ids +
    (n, d) store -> (Q, d), averaged over the stream; stands in for
    whatever consumes retrieval results on the device."""
    return vecs[ids.long()].mean(dim=(0, 2))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = torch.device(args.device)
    utils.enable_compilation_cache()
    k, P = args.k, args.n_probes
    R1, R2 = args.reps

    if args.glove:
        ivf = load_ivf(os.path.join(args.cache_dir, _glove.index_name()),
                       dev)
        corpus, queries = utils.make_clustered(_glove.SIZE, _glove.DIM,
                                               _glove.N_QUERIES)
        nq = _glove.N_QUERIES
    else:
        rng = np.random.default_rng(0)
        corpus = rng.standard_normal((20000, 64), dtype=np.float32)
        queries = rng.standard_normal((1024, 64), dtype=np.float32)
        ivf = IVF("angular", 64, FastPQ(2, rotate_dim=None, device=dev),
                  device=dev)
        ivf.fit(corpus).build(corpus, n_probes=2)
        nq = len(queries)

    # stage-2 operand: the stored vectors, placed once (any per-id side
    # table works the same way: embeddings, payload features, ...)
    vecs = torch.as_tensor(corpus, device=dev)
    qbs = {r: torch.as_tensor(queries[None] + np.arange(
        r, dtype=np.float32)[:, None, None] * 1e-6, device=dev)
        for r in (R1, R2)}

    def pipelined_block(r):
        ids, _ = ivf.query_stream(qbs[r], k=k, n_probes=P,
                                  device_out=True)    # stays on device
        return read_head(ids, vecs)

    def host_hop_block(r):
        ids = ivf.query_stream(qbs[r], k=k, n_probes=P).cpu()  # ids -> host
        return read_head(ids.to(dev), vecs)                    # -> device

    def pipelined(r):
        return float(pipelined_block(r).sum())         # scalar readback

    def host_hop(r):
        return float(host_hop_block(r).sum())

    def marginal(fn):
        el = {}
        for r in (R1, R2):
            fn(r)                                        # warm
            best = float("inf")
            for _ in range(3):
                t0 = time.time()
                fn(r)
                best = min(best, time.time() - t0)
            el[r] = best
        return (el[R2] - el[R1]) / (R2 - R1) if el[R2] > el[R1] \
            else el[R2] / R2

    # same ids, same pool: the two pipelines must agree bit for bit
    same = bool(torch.equal(pipelined_block(R1), host_hop_block(R1)))
    if not same:
        raise AssertionError("the device_out pipeline and the host hop "
                             "pooled different blocks")

    t_pipe = marginal(pipelined)
    t_host = marginal(host_hop)
    print(f"two-stage retrieval pipeline, Q={nq} k={k} P={P} "
          f"(marginal/rep, best-of-3 at R={R1},{R2}):")
    print(f"  device_out pipelined : {t_pipe * 1e3:8.2f} ms/rep "
          f"({nq / t_pipe:,.0f} QPS)")
    print(f"  host hop between     : {t_host * 1e3:8.2f} ms/rep "
          f"({nq / t_host:,.0f} QPS)")
    print(f"  host-hop overhead    : {(t_host - t_pipe) * 1e3:8.2f} ms/rep")
    return {"pooled_equal": same, "device_out_s": t_pipe,
            "host_hop_s": t_host, "n_queries": nq}


if __name__ == "__main__":
    main()
