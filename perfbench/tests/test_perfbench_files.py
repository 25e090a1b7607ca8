"""Every file the benchmark names loads, and they agree with each other."""

import json
import os
import re

import pytest

from perfbench import common
from perfbench.run import load_reader

BENCH = json.load(open(os.path.join(common.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_loads(cell):
    wl = common.load_workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic_name"] == entry["traffic"]
    assert wl["chips"] == entry["chips"] == 1
    assert os.path.exists(os.path.join(common.HERE, "drivers",
                                       f"{wl['driver']}.py"))
    assert set(wl["limits"]) <= {"loss_gap", "grad_gap", "change_gap"}
    assert "change_gap" in wl["limits"]
    assert all(0 < v < 1 for v in wl["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_loads(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    model = json.load(open(os.path.join(common.ROOT, entry["file"])))
    assert model["name"] == config
    assert model["reduced"] == entry["reduced"]
    assert os.path.exists(os.path.join(common.HERE, "configs",
                                       f"{model['reference']}.py"))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    read = load_reader(metric)
    from perfbench.run import Context

    assert read(Context(kind="none")) is None


def test_names_and_cross_references():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert cell in e.get("workloads", CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        has = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in has] and len(has) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
