"""BENCHMARK.json: its shape, and every cell resolving to its files."""

import json
import re

import pytest

from benchmark import run

SPEC = run.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files(cell):
    parts = run.resolve(SPEC, cell)
    assert parts["entry"].is_file()
    assert parts["config"]["entry"] == parts["entry"].stem
    assert {"sample", "engine", "limits"} <= set(parts["config"])
    assert parts["traffic"]["quality"]
    names = {m["name"] for m in parts["per_layer"]}
    assert names, "every cell reports a per-layer metric"
    for name in names:
        assert callable(run.metric_reader(name))
    ends = {m["name"] for m in parts["end_to_end"]}
    assert "setup_s" in ends and len(ends) >= 2
    assert {m["moves"] for m in parts["per_layer"]} <= ends
    assert parts["cell"]["chips"] == 1


def test_names_units_and_references():
    configs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert configs == used
    ends = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(run.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(SPEC)) < 64 * 1024
