"""Every cell, configuration and metric that BENCHMARK.json names has its files, and the
file obeys the contract's limits on names, units and bounds."""

from __future__ import annotations

import json
import re

import pytest

from portbench.run import REPO, ROOT, load_json, load_module

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_file(name):
    """Every workload file names a configuration and a traffic kind that
    exist, and is listed in BENCHMARK.json with the same entries."""
    w = load_json("workloads", name)
    config = load_json("configs", w["config"])
    assert config["name"] == w["config"]
    assert (ROOT / "traffic" / f"{w['kind']}.py").exists()
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())
    listed = {c["name"]: c for c in BENCH["workloads"]}
    assert {k: listed[name][k] for k in ("config", "traffic", "chips", "why")} == \
        {k: w[k] for k in ("config", "traffic", "chips", "why")}


def test_every_cell_has_its_file():
    assert {c["name"] for c in BENCH["workloads"]} <= set(WORKLOADS)


def test_configs_named_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and NAME.match(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("section,kind", [("end_to_end", "e2e"), ("per_layer", "metrics")])
def test_metric_modules(section, kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(load_module(kind, m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
        if section == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        else:
            assert m["moves"] in e2e and "\n" not in m["layer"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
        moved = {m["name"] for m in e2e}
        assert all(m["moves"] in moved for m in per)
