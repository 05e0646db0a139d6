"""Every configuration, traffic mix, limit and per-layer metric that
BENCHMARK.json names loads by its name, and the file keeps the
benchmark's contract of names, units and keys."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(cfg):
    assert NAME.match(cfg["name"]) and set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = harness.load_json(harness.ROOT, cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    for obj in data["objects"]:
        if obj["kind"] == "mesh":
            assert os.path.exists(os.path.join(harness.ROOT, obj["obj"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_load(cell):
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    traffic = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
    assert os.path.exists(os.path.join(harness.HERE, "loops", traffic["kind"] + ".py"))
    harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    limits = harness.load_json(harness.HERE, "limits", cell["name"] + ".json")
    assert limits and all(v > 0 for v in limits.values())
    _, e2e, layer = harness.cell_spec(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        reader = harness.load_module(os.path.join(harness.HERE, "metrics", metric["name"] + ".py"),
                                     "t_" + metric["name"].replace(".", "_"))
        assert callable(reader.read)
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    json.dumps(BENCH)
