"""A cell at a size the CPU tests can hold: the program's plain kernel
versions on the CPU, the configuration's shapes and algorithm, fewer
points, lists and queries. Cells are told apart by their
configuration's engine, never by their place in BENCHMARK.json."""

import json
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = CHECKOUT / "BENCHMARK.json"
SMALL = {"dataset": {"size": 30000, "n_queries": 300},
         "index": {"n_clusters": 96}}
# a shallower pool than the cells', so that recall stays below 1 at this
# size and the fold, the pool cut and the probe order decide the answers
SHALLOW = {"query": {"n_probes": 2, "pass_1": 30}}


def cells() -> list:
    return [w["name"] for w in json.loads(BENCH.read_text())["workloads"]]


def scan_impl(cell: str) -> str:
    """The list-scan engine of the cell's configuration."""
    from gpubench import core
    spec = core.load_spec(BENCH)
    return core.load_config(BENCH, core.cell_of(spec, cell)[1])[
        "index"]["scan_impl"]


def pq_cells() -> list:
    return [c for c in cells() if scan_impl(c) != "exact"]


def override(cell: str, extra=None) -> dict:
    """SMALL (and SHALLOW for the PQ engine), then ``extra``'s values by
    section."""
    out = {k: dict(v) for k, v in SMALL.items()}
    if scan_impl(cell) != "exact":
        out.update({k: dict(v) for k, v in SHALLOW.items()})
    for section, values in (extra or {}).items():
        out[section] = dict(out.get(section, {}), **values)
    return out


def quiet(*args, **kw):
    pass


def run(cell: str, seed: int = 5, trace: bool = False, fault=None,
        seconds: float = 0.3, bench: Path = BENCH, extra=None) -> dict:
    from gpubench import core
    return core.run_cell(cell, seed, seconds, trace, bench_file=bench,
                         device="cpu", override=override(cell, extra),
                         fault=fault, log=quiet)
