"""A cell at a size the CPU tests can hold: the program's plain kernel
versions on the CPU, the configuration's shapes and algorithm, fewer
points, lists and queries."""

from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = CHECKOUT / "BENCHMARK.json"
SMALL = {"dataset": {"size": 30000, "n_queries": 300},
         "index": {"n_clusters": 96}}
# a shallower pool than the cells', so that recall stays below 1 at this
# size and the fold, the pool cut and the probe order decide the answers
SHALLOW = {"query": {"n_probes": 2, "pass_1": 30}}


def override(cell: str) -> dict:
    if "exact" in cell:
        return SMALL
    return dict(SMALL, **SHALLOW)


def quiet(*args, **kw):
    pass


def run(cell: str, seed: int = 5, trace: bool = False, fault=None,
        seconds: float = 0.3, bench: Path = BENCH) -> dict:
    from gpubench import core
    return core.run_cell(cell, seed, seconds, trace, bench_file=bench,
                         device="cpu", override=override(cell),
                         fault=fault, log=quiet)
