"""Probe-coverage recall ceiling of an IVF archive (counterpart of
examples/coverage_ceiling.py), in NumPy only.

For each n_probes: the best recall@k any scan engine can reach, with
exact probe selection (true distances to the active centers) and an
exact f32 brute force over the union of the probed lists. A true
neighbour outside every probed list is out of reach; the gap between
this ceiling and a measured recall is the engine's own loss (estimate
noise, fold collisions, bf16 rounding, capacity drops). It runs no
device code, so it takes no ``--device``.

    python -m tinyknn_tpu_torch.examples.coverage_ceiling \\
        [--index ivf_....npz] [--probes 1 2 3 4 6 10] [--k 10]

The dataset is derived from the index file name (``clustered-<n>-<d>``
/ ``random-<n>-<d>``, the generators of ``bench``), or ``--data``.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

from .. import utils
from . import _glove


def _parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--index", default=_glove.index_name())
    parser.add_argument("--probes", type=int, nargs="+",
                        default=[1, 2, 3, 4, 6, 10])
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--n-queries", type=int, default=10000)
    parser.add_argument("--data", default=None,
                        help=".npy dataset (queries = the last n-queries "
                             "rows); default: synthesize from the index "
                             "file name")
    parser.add_argument("--trus", default=None,
                        help="ground-truth .npy (default: bench's cache "
                             "name in --cache-dir)")
    parser.add_argument("--cache-dir", default=".",
                        help="where the default ground truth is read from")
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    with np.load(args.index) as z:
        C = z["active_centers"]
        data = z["data"]                  # normalized copy stored at build
        tile_off, counts, csr_ids = (z["tile_offsets"], z["list_counts"],
                                     z["csr_ids"])
    metric = "angular" if "angular" in args.index else "euclidean"
    nq, k = args.n_queries, args.k

    m = re.search(r"(clustered|random)-(\d+)-(\d+)", args.index)
    if args.data is not None:
        queries = np.load(args.data)[-nq:]
    elif m:
        kind, size, dim = m.group(1), int(m.group(2)), int(m.group(3))
        if kind == "clustered":
            queries = utils.make_clustered(size, dim, nq)[1]
        else:
            queries = np.random.default_rng(10).standard_normal(
                (size + nq, dim), dtype=np.float32)[-nq:]
    else:
        raise SystemExit("cannot derive the dataset from the index name; "
                         "pass --data")

    if metric == "angular":
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)

    trus_file = args.trus
    if trus_file is None and m:
        trus_file = os.path.join(
            args.cache_dir, f"trus_{m.group(0)}_k_neighbours={k}_"
                            f"num_queries={nq}_metric='{metric}'.npy")
    if not (trus_file and os.path.isfile(trus_file)):
        raise SystemExit(f"ground-truth file not found ({trus_file}); run "
                         "the bench sweep once (it caches it) or pass "
                         "--trus")
    true_sets = [set(t.tolist()) for t in np.load(trus_file)[:, :k]]

    # exact probe selection, best first (the library's: true distances
    # to the active centers)
    P_max = max(args.probes)
    if metric == "angular":
        order = np.argsort(-(queries @ C.T), axis=1)[:, :P_max]
    else:
        d2 = ((queries ** 2).sum(1)[:, None] - 2 * queries @ C.T
              + (C ** 2).sum(1)[None])
        order = np.argsort(d2, axis=1)[:, :P_max]

    lists = [csr_ids[tile_off[c] * 128: tile_off[c] * 128 + counts[c]]
             for c in range(len(counts))]

    rows = []
    for P in args.probes:
        found = member = total_pts = 0
        for i in range(nq):
            # unique: a build_probes >= 2 archive spills each point into
            # several lists; duplicates would crowd the top-k
            ids = np.unique(np.concatenate(
                [lists[c] for c in order[i, :P]]))
            total_pts += len(ids)
            member += len(true_sets[i].intersection(ids.tolist()))
            if metric == "angular":
                d = -(data[ids] @ queries[i])
            else:
                d = ((data[ids] - queries[i]) ** 2).sum(1)
            top = ids[np.argpartition(d, min(k - 1, len(ids) - 1))[:k]]
            found += len(true_sets[i].intersection(top.tolist()))
        # membership is the pure coverage bound (set-based, immune to
        # distance rounding); the brute-force line matches it when the
        # truth is exact
        rows.append({"n_probes": P, "membership": member / (k * nq),
                     "recall": found / (k * nq),
                     "candidates": total_pts / nq})
        print(f"P={P:>2}: membership={member / (k * nq):.4f}  "
              f"union-brute recall{k}@{k} = {found / (k * nq):.4f}  "
              f"(avg {total_pts / nq:,.0f} candidates/query)", flush=True)
    return {"rows": rows}


if __name__ == "__main__":
    main()
