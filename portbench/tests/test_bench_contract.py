"""BENCHMARK.json against the characters and shapes its contract allows,
and every name it gives found as a file."""

import json
import os
import re

import pytest

from portbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    b = bench()
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for c in b["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_bounds_and_metric_keys():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:      # every cell reports a per-layer metric
        assert any(cell in m["workloads"] for m in b["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_every_name_has_its_file(kind):
    b = bench()
    if kind == "configs":
        files = [c["file"] for c in b["configs"]]
    elif kind == "traffic":
        files = [f"portbench/traffic/{w['traffic']}.json"
                 for w in b["workloads"]]
    else:
        files = [f"portbench/metrics/{m['name']}.py"
                 for m in b["end_to_end"] + b["per_layer"]]
    for f in files:
        assert os.path.isfile(os.path.join(ROOT, f)), f


def test_configs_name_their_cuts():
    b = bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert cfg["name"] == c["name"]
        assert all(v is not None for v in cfg["limits"].values())
