"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: each cell's configuration, traffic mix and limits, each
per-layer metric's reader."""

import os
import re

import pbtest
from portbench import byname, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_units():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_name_has_its_file():
    b = harness.benchmark()
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(pbtest.ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        driver = harness.traffic_of(w["traffic"])["driver"]
        assert callable(byname.load("drivers", driver).run)
        kind = harness.config_of(b, w)["scene"]["kind"]
        assert callable(byname.load("scenes", kind).make)
        assert harness.limits_of(w["name"])
        cell_metrics = harness.metrics_for(b, w["name"], True)
        assert cell_metrics
        for m in cell_metrics:
            assert callable(harness.reader(m["name"]))
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_a_program_switch_in_the_environment_is_refused():
    assert harness.program_knobs({"RAYTPU_B0": "mega", "HOME": "/h",
                                  "RAYTPU": "x"}) == ["RAYTPU_B0"]
    assert "knobs" not in harness.config_of(
        harness.benchmark(), harness.benchmark()["workloads"][0])
