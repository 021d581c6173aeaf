"""One run of one cell: set up the system, measure a window, judge what
it answered and built against the reference, and report the cell's
metrics.

Everything that belongs to one cell, configuration, traffic mix or kind,
entry or metric is a file of its own that this module finds by the name
that BENCHMARK.json, the configuration or the mix gives (README.md).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import judge
from . import trace as trace_mod

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyknn_tpu")


class NoDevice(RuntimeError):
    """The run needs more CUDA devices than this machine has."""


def load_spec(bench_file: Path) -> dict:
    return json.loads(Path(bench_file).read_text())


def cell_of(spec: dict, name: str) -> tuple[dict, dict]:
    """(workload entry, configuration entry) of the cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, config


def load_config(bench_file: Path, entry: dict, override=None) -> dict:
    """A configuration's file, with ``override``'s values (by section)
    in place of its own."""
    config = json.loads((Path(bench_file).resolve().parent
                         / entry["file"]).read_text())
    for section, values in (override or {}).items():
        config[section] = dict(config[section], **values)
    return config


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones
    without a trace, the per-layer ones with it."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def part(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = ROOT / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The ``read(run)`` of the metric ``name``."""
    return part("metrics", name).read


def forbidden_modules(names=None) -> list[str]:
    """Of the module names (default: those loaded), the top-level names
    that are JAX's, Flax's or the JAX package's, compared whole (the
    port's name begins with the JAX package's)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             bench_file: Path, device="cuda", t_start=None, override=None,
             fault=None, log=print) -> dict:
    """One run. Returns the result line's object. ``override``: values
    that replace the configuration's, by section (``{"dataset": {"size":
    ...}}``; CPU tests only). ``fault``: a function that breaks the
    entry underneath before its set-up (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    spec = load_spec(bench_file)
    cell, centry = cell_of(spec, cell_name)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count()
                                  < cell["chips"]):
        raise NoDevice(f"{cell_name} needs {cell['chips']} CUDA device(s)")
    config = load_config(bench_file, centry, override)
    wl = json.loads((ROOT / "workloads" / f"{cell_name}.json").read_text())
    mix = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    kind = part("traffic", mix["kind"])
    entry = part("entries", config["entry"]).Entry(config, device)

    # -- set-up
    if fault is not None:
        fault(entry)
    client = kind.plan(mix, seed, seconds, entry.queries, entry.k)
    spans = entry.setup()
    kind.warm(entry.query, client)
    _sync(device)
    # what set-up made lives to the end: keep it out of the collector's
    # full passes, whose pauses would land in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({spans})", file=sys.stderr)

    # -- the window
    before = entry.counters()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    span = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    with span(trace_mod.WINDOW):
        out = kind.serve(entry.query, client, seconds, span)
        _sync(device)
    gc.unfreeze()
    tr = None
    if prof is not None:
        prof.stop()
        t_read = time.perf_counter()
        tr = trace_mod.read(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t_read:.3f} s",
            file=sys.stderr)
    after = entry.counters()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # -- judge, once the peak is read; the entry frees the program first
    judged = entry.judge(out, wl, seed)
    correct, checks = judge.decide(judged.numbers, wl["limits"])
    record = SimpleNamespace(
        kind=mix["kind"], setup_s=setup_s, spans=spans,
        window_s=out.window_s, queries=out.queries, calls=out.calls,
        counters={k: after[k] - before[k] for k in after},
        recall=judged.recall, trace=tr, view=judged.view)
    metrics = {}
    for m in metrics_of(spec, cell_name, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": trace_mod.top(tr.kernels),
                               "idle_gaps": trace_mod.top(tr.idle_gaps)}
    result["checks"] = checks
    return result
