"""Whole runs on the CPU at tiny sizes, the look for a card skipped: the
result line's keys, a configuration and a mix added as files only, the
control and the timed path's faults coming out not correct."""
import subprocess
import sys
import time

import pytest
import torch

from wfbench import harness
from wfbench.reference import ControlTable
from wfbench.tests.tiny import REPO, make_root

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace=False, seed=2**31 + 3, **kw):
    return harness.run(root, cell, seed, 0.4, trace, time.perf_counter(),
                       device="cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.b", "tiny-kv.d"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_added_as_files_run_correct(root, cell, trace):
    result, lines, checks = run(root, cell, trace)
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert len(checks) == len(result["checks"])
    names = set(result["metrics"])
    if trace:
        assert {"round_p95_ms.host", "slowpath_share",
                "slowpath_txn_share"} <= names
        assert ("payload_ms_per_round" in names) == cell.startswith("tiny-kv")
        assert "trace" in lines[0]
    else:
        assert names == {"ops_per_s", "bytes_per_item", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}


@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.d"])
def test_load_and_final_read_in_several_calls(root, cell, monkeypatch):
    monkeypatch.setattr(harness, "CHUNK", 100)
    result, _, _ = run(root, cell)
    assert result["correct"] is True
    assert result["checks"]["content_mismatches"]["value"] == 0


@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.b", "tiny-kv.d"])
def test_control_is_not_correct(root, cell):
    result, _, _ = run(root, cell,
                       table_factory=lambda c, d, f: ControlTable(d, f))
    assert result["correct"] is False
    assert result["checks"]["found_mismatches"]["value"] > 0 or \
        result["checks"].get("payload_mismatches", {}).get("value", 0) > 0


def _state_unchanged(apply):
    def fault(plan, cfg, state, ops):
        from repro_torch.core.table import BatchResult
        return state, BatchResult(status=torch.zeros_like(ops.kind,
                                                          dtype=torch.int8),
                                  error=state.error)
    return fault


def _half_left_out(apply):
    def fault(plan, cfg, state, ops):
        lane = torch.arange(ops.kind.numel())
        kept = ops._replace(kind=torch.where(lane < lane.numel() // 2,
                                             ops.kind, 0))
        return apply(plan, cfg, state, kept)
    return fault


def _answer_altered(lookup):
    def fault(plan, cfg, state, queries):
        found, word = lookup(plan, cfg, state, queries)
        found = found.clone()
        found[0] = ~found[0]
        return found, word
    return fault


FAULTS = {"state_unchanged": ("plan_apply", _state_unchanged),
          "half_left_out": ("plan_apply", _half_left_out),
          "answer_altered": ("plan_lookup", _answer_altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.b"])
def test_timed_path_faults_are_not_correct(root, cell, fault, monkeypatch):
    harness.import_program()
    from repro_torch.kernels import ops as kops
    name, make = FAULTS[fault]
    monkeypatch.setattr(kops, name, make(getattr(kops, name)))
    result, _, _ = run(root, cell)
    assert result["correct"] is False


def test_without_a_card_no_result_and_a_failing_exit():
    p = subprocess.run([sys.executable, "wfbench/run.py", "--workload",
                        "paper-int.mix90", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.b", "tiny-kv.d"])
def test_tiny_cells_on_the_card(root, cell, card):
    result, _, _ = harness.run(root, cell, 11, 1.0, True, time.perf_counter(),
                               device=card)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
