"""Every name in BENCHMARK.json resolves to its file, and the file keeps
to the benchmark's contract (keys, names, units, the metrics' links)."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(run.__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert conf["file"].startswith("portbench/configs/")
    assert "control" in data


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    spec = run.resolve(BENCH, cell["name"])
    importlib.import_module(f"portbench.drivers.{spec['mix']['driver']}")
    assert spec["limits"], "a cell's limits file names its numbers"
    reported = [m for m in METRICS if cell["name"] in
                m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported}
    assert len([m for m in BENCH["end_to_end"] if m in reported]) >= 2
    assert [m for m in BENCH["per_layer"] if m in reported]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(run.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for cell in metric.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
        if metric["name"].endswith("_roofline_pct") or "mfu" in \
                metric["name"]:
            assert metric["unit"] == "%"


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
