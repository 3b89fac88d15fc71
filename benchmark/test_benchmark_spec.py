"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit and metric reader exists, parses and agrees with it."""

import json
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    mod = run.metric_reader(m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25 and mod.BETTER == m["better"]
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    cell = run.load_cell(w["name"])
    assert cell.chips == 1 and NAME.match(w["traffic"])
    assert len(w["why"]) <= 200 and cell.limits
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.traffic["mode"] in ("quant", "build")


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    conf = json.load(open(os.path.join(ROOT, c["file"])))
    assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    assert all(k in conf for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])
