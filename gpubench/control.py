"""The control of the judge: the reference put in the program's place and
computed one step below the configuration's precision (f32 products on
TF32 operands, bf16 vectors as fp8), judged exactly as a run of the cell
judges the program. Its numbers set the upper readings of the limits in
workloads/<cell>.json, and a run of it has to come out not correct.

    python gpubench/control.py --workload <cell> --seeds 1 2 3 \
        [--cut-fit 1 3]

Per seed it prints the judge's numbers, each beside its limit, and
``correct``; with ``--cut-fit``, the fit numbers of the program's fit
cut to so many Lloyd passes, the fault the fit numbers have to catch.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

CHECKOUT = Path(__file__).resolve().parent.parent


def slots(index) -> dict:
    """A reference index in the per-slot form ``Entry.claims`` gives."""
    valid = index.members >= 0
    lists = torch.arange(index.members.shape[0], device=valid.device)
    lists = lists[:, None].expand_as(index.members)[valid]
    ids = index.members[valid]
    return {"slot_ids": ids, "slot_centers": index.active[lists],
            "slot_codes": index.codes[ids],
            "slot_vecs": None if index.aug is None else index.aug[ids]}


def _cell(cell_name, bench_file, device, override):
    """(the entry module the configuration names, its Entry, the cell's
    judge, its traffic mix)."""
    from gpubench import core
    spec = core.load_spec(bench_file)
    cell, centry = core.cell_of(spec, cell_name)
    config = core.load_config(bench_file, centry, override)
    wl = json.loads((core.ROOT / "workloads"
                     / f"{cell_name}.json").read_text())
    mix = json.loads((core.ROOT / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    entries = core.part("entries", config["entry"])
    return entries, entries.Entry(config, device), wl, mix


def _fit(entry, iters=None):
    """The program's fit, with ``iters`` Lloyd passes in place of its
    own (the coarse k-means and the codebooks') when given."""
    if iters is not None:
        entry.ivf.kmeans_iters = entry.ivf.pq.kmeans_iters = iters
    entry.ivf.fit(entry.X)
    return {"centers": entry.ivf.all_centers.clone(),
            "codebooks": entry.ivf.pq.center_blocks.clone()}


def run(cell_name: str, seeds, *, bench_file: Path,
        device="cuda", override=None, log=print) -> list:
    """[(seed, numbers, correct, checks)] of the control on each seed.
    The control derives its index from the program's fit and the
    configuration's projection (as the judge does), so its fit numbers
    are the program's."""
    from gpubench import judge
    from gpubench.reference import ivf as ref
    entries, entry, wl, mix = _cell(cell_name, bench_file, device, override)
    t0 = time.perf_counter()
    fit = _fit(entry)
    log(f"program fit {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    del entry.ivf
    qcfg = entries.query_config(entry.config)
    index = ref.derive(entry.X, fit["centers"], fit["codebooks"], qcfg,
                       ref.Precision())
    low = ref.derive(entry.X, fit["centers"], fit["codebooks"], qcfg,
                     ref.Precision(lower=True))
    claims = dict(slots(low), **fit)
    Qf = torch.from_numpy(entry.queries).to(index.data.device)
    n = Qf.shape[0]
    Q = min(int(mix["batch"]), n)
    out = []
    for seed in seeds:
        rows = torch.from_numpy(
            np.random.default_rng(seed).permutation(n)[:Q]).to(Qf.device)
        ids, _ = ref.answers(low, Qf[rows], qcfg, ref.Precision(lower=True),
                             Q=Q)
        numbers, _ = entries.judge_numbers(
            index, qcfg, Q, Qf, claims, ids, rows,
            torch.ones(Q, dtype=torch.float64, device=Qf.device), wl["tau"])
        numbers.update(entries.fit_numbers(
            index, claims, seed, qcfg["metric"] == "angular"))
        correct, checks = judge.decide(numbers, wl["limits"])
        out.append((seed, numbers, correct, checks))
    return out


def cut_fit(cell_name: str, iters: int, seeds, *, bench_file: Path,
            device="cuda", override=None) -> list:
    """[(seed, fit numbers)] of the program's fit cut to ``iters`` Lloyd
    passes: the fault that the fit numbers have to catch."""
    from gpubench.reference import ivf as ref
    entries, entry, _, _ = _cell(cell_name, bench_file, device, override)
    fit = _fit(entry, iters)
    del entry.ivf
    qcfg = entries.query_config(entry.config)
    index = ref.derive(entry.X, fit["centers"], fit["codebooks"], qcfg,
                       ref.Precision())
    return [(seed, entries.fit_numbers(index, fit, seed,
                                       qcfg["metric"] == "angular"))
            for seed in seeds]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--cut-fit", type=int, nargs="*", default=[],
                   help="also read the fit numbers of the program's fit "
                   "cut to each of these numbers of Lloyd passes")
    args = p.parse_args(argv)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    bench = CHECKOUT / "BENCHMARK.json"
    for seed, numbers, correct, checks in run(args.workload, args.seeds,
                                              bench_file=bench):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True, "correct": correct,
                          "checks": checks}), flush=True)
    for iters in args.cut_fit:
        for seed, numbers in cut_fit(args.workload, iters, args.seeds,
                                     bench_file=bench):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fit_iters": iters, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
