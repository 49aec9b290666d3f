"""A throwaway benchmark root for the CPU tests: the committed metrics
readers and traffic files copied beside tiny configurations and mixes of
its own, and a ``BENCHMARK.json`` naming them. Nothing under ``wfbench/``
is edited to add them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

TINY_INT = {
    "spec": {"dmax": 12, "bucket_size": 8, "pool_size": 1024,
             "n_lanes": 64, "initial_depth": 4},
    "keys": {"universe": 1024},
}
TINY_KV = {
    "spec": {"dmax": 12, "bucket_size": 8, "pool_size": 1024,
             "n_lanes": 64, "initial_depth": 5, "slab_capacity": 512},
    "schema": {"a": ["uint8", [8]], "b": ["uint8", [4]]},
    "keys": {"records": 256},
}
TINY_MIXES = {
    "tiny-mix": {"reads": {"count": 256, "pick": "uniform"},
                 "writes": {"ops": [
                     {"kind": "insert", "count": 48, "pick": "uniform"},
                     {"kind": "delete", "count": 48, "pick": "uniform"}]}},
    "tiny-b": {"theta": 0.99, "reads": {"count": 200, "pick": "zipfian"},
               "writes": {"call": "update", "ops": [
                   {"kind": "update", "count": 80, "pick": "zipfian"}]}},
    "tiny-d": {"theta": 0.99, "reads": {"count": 200, "pick": "latest"},
               "writes": {"ops": [
                   {"kind": "insert", "count": 40, "pick": "new"},
                   {"kind": "delete", "count": 40, "pick": "oldest"}]}},
}
CELLS = {"tiny-int.mix": ("tiny-int", "tiny-mix"),
         "tiny-kv.b": ("tiny-kv", "tiny-b"),
         "tiny-kv.d": ("tiny-kv", "tiny-d")}


def make_root(tmp: Path) -> Path:
    """``tmp`` as a benchmark root: the committed ``wfbench`` data and
    readers copied, the tiny files added, and a ``BENCHMARK.json`` that
    extends the committed one with the tiny cells."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = tmp / "wfbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, base / sub)
    for name, cfg in (("tiny-int", TINY_INT), ("tiny-kv", TINY_KV)):
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({
            "name": name, "source": "test", "reduced": [], "why": "test",
            "file": f"wfbench/configs/{name}.json"})
    for name, mix in TINY_MIXES.items():
        (base / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (config, traffic) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["per_layer"]:
            if "workloads" in m and config == "tiny-kv":
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
