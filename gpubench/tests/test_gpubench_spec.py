"""BENCHMARK.json against the benchmark contract, and every file it
names found."""

import json
import re

import pytest

from gpubench import core
from gpubench.tests.smallrun import BENCH, CHECKOUT

SPEC = json.loads(BENCH.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    assert len(BENCH.read_bytes()) <= 64 * 1024


def test_check_fits_its_time_with_every_cell():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"].startswith("gpubench/configs/")
    cfg = json.loads((CHECKOUT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    assert {"entry", "dataset", "index", "query", "assumed"} <= set(cfg)
    assert hasattr(core.part("entries", cfg["entry"]), "Entry")
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda e: e["name"])
def test_cell_entry_and_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert LINE.match(cell["why"]) and cell["chips"] == 1
    wl = json.loads((core.ROOT / "workloads"
                     / f"{cell['name']}.json").read_text())
    assert wl["limits"] and wl["tau"] > 0
    mix = json.loads((core.ROOT / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    kind = core.part("traffic", mix["kind"])
    assert all(callable(getattr(kind, f)) for f in ("plan", "warm", "serve"))
    trace0 = {m["name"] for m in core.metrics_of(SPEC, cell["name"], False)}
    trace1 = {m["name"] for m in core.metrics_of(SPEC, cell["name"], True)}
    assert "setup_s" in trace0 and len(trace0) >= 2 and trace1


def test_cells_are_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = ([m["name"] for m in METRICS] + [c["name"] for c in
             SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]])
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    e2e = metric in SPEC["end_to_end"]
    keys = ({"name", "unit", "better", "bound", "source"} if e2e else
            {"name", "unit", "better", "source", "layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert LINE.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert callable(core.reader(metric["name"]))
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
