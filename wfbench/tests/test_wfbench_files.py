"""BENCHMARK.json's shape and limits, and every configuration,
traffic mix and per-layer metric found by its name."""
import json
import re
from pathlib import Path

import pytest

from wfbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "wfbench/run.py"]
    assert BENCH["paths"] == ["wfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    cfg_keys = {"name", "source", "file", "reduced", "why"}
    cell_keys = {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == cfg_keys and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("wfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == cell_keys and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    files = harness.load_cell(REPO, cell)
    assert files["config"]["spec"]["dmax"] <= 20
    assert files["traffic"]["reads"]["count"] > 0
    for m in files["per_layer"]:
        assert callable(harness.load_reader(files["base"], m["name"]))
    assert {m["name"] for m in files["end_to_end"]} == {
        "ops_per_s", "bytes_per_item", "setup_s"}


def test_every_config_used_and_every_file_named():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    traffic = {p.stem for p in (REPO / "wfbench" / "traffic").glob("*.json")}
    assert {w["traffic"] for w in BENCH["workloads"]} <= traffic
    readers = {p.stem for p in (REPO / "wfbench" / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} == readers


def test_config_files_state_their_source_and_guarantees():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] and cfg["guarantees"] and "assumed" in cfg
        assert cfg["reduced"] == c["reduced"]
