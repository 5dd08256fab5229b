"""Every file the harness finds by name exists, loads and keeps to the
benchmark's naming rules."""

import json
import re

import pytest

import harness

BENCH = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cudabench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_reader(metric):
    assert NAME.match(metric["name"]), metric["name"]
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.load_module("metrics", metric["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert NAME.match(cell)
    assert c.chips == 1
    assert harness.load_module("checks", c.workload["check"]).numbers
    assert harness.load_module("traffic", c.mix["driver"]).Driver
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    if (c.workload["trace"]["mode"] == "replays"
            or c.workload["check"] == "train_losses"):
        assert harness.replay_steps(c) > 0


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    body = json.loads((harness.REPO / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in body and key in body["reduced_why"]
    assert body["precision"] == "highest"


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_every_per_layer_metric_lists_its_cells():
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS), m
