"""BENCHMARK.json and the files it names: every configuration, traffic
and metric loads by name, and every name, unit and text keeps to the
benchmark's character rules."""

import json
import os
import re

import pytest

import check
import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _text(s):
    assert isinstance(s, str) and 1 <= len(s) <= 200
    assert "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        _text(c["source"])
        _text(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert cfg[key] != cfg["reduced_from"][key]
        assert isinstance(cfg["threads"], int) and cfg["threads"] >= 1


def test_workloads_load_by_name():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        _text(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"], BENCH)
        args = harness.sample_args(cell.config, cell.traffic)
        assert args["min_bp"] < args["max_bp"]
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    seen = set()
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        _text(m["layer"])
        assert callable(harness.load_reader(m["name"]))


def test_traffic_is_data():
    """Every traffic file, a cell's or one kept for a later cell."""
    names = {w["traffic"] for w in BENCH["workloads"]} | {
        f[:-len(".json")] for f in os.listdir(
            os.path.join(harness.HERE, "traffic")) if f.endswith(".json")}
    for name in sorted(names):
        t = json.load(open(os.path.join(harness.HERE, "traffic",
                                        name + ".json")))
        assert set(t) <= {"genome_scale", "flags", "jobs", "checks"}
        # every number compared is read by its own file, with a limit
        assert "graph_edges_differ" in t["checks"]
        for name, limit in t["checks"].items():
            assert NAME.match(name) and isinstance(limit, (int, float))
            assert callable(check.load_check(name))


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_metric_lists_name_their_cells(w):
    """A metric that lists cells is read in each (its reader's source
    span or kernel exists on that cell's route)."""
    cell = harness.load_cell(w, BENCH)
    names = {m["name"] for m in cell.per_layer}
    assert "device_idle_pct" in names and "build_lib_s" in names
    onepass = "--presets" in cell.config["flags"]
    assert ("onepass_build_s" in names) == onepass
    assert ("mercy_s" in names) == (not onepass)
