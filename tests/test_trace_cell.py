"""``tools/trace_cell.py`` on the CPU: the tiny benchmark cells run
traced with the program's telemetry on, their checks still pass and the
benchmark's own metrics are still reported, beside the program-side
metrics (``payload_host_ms_per_round`` on the schema cells only); each
metric is None without its record; device idle time is put down to the
innermost program span."""
import importlib.util
import types
from pathlib import Path

import pytest

TOOL = Path(__file__).resolve().parents[1] / "tools" / "trace_cell.py"
spec = importlib.util.spec_from_file_location("trace_cell", TOOL)
tc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tc)

from wfbench.tests.tiny import make_root  # noqa: E402  (path set by tc)

HOST = {"host_syncs_per_round", "sync_wait_ms_per_round",
        "dispatch_self_ms_per_round", "facade_self_ms_per_round",
        "slowpath_lane_share"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-int.mix", "tiny-kv.b"])
def test_tiny_cells_traced_with_telemetry(root, cell):
    result, lines, checks, line = tc.traced(cell, 2**31 + 3, 0.4,
                                            device="cpu", root=root)
    assert result["correct"] is True and result["failed"] == 0
    assert {"slowpath_share", "slowpath_txn_share"} <= set(result["metrics"])
    tel = line["telemetry"]
    names = set(tel["metrics"])
    kv = cell.startswith("tiny-kv")
    assert names == HOST | ({"payload_host_ms_per_round"} if kv else set())
    assert "profiled" not in tel       # no card: no profile
    c, hand = tel["counters"], tel["hand_count"]
    assert hand["sync.need_slow"] == tel["summary"]["repro.facade.txn"][
        "calls"] > 0
    assert ("sync.reconcile" in hand) == kv
    # + one wave loop a transaction in the kernels' plain versions
    want = dict(hand, **{"sync.waves": hand.get("sync.waves", 0)
                         + hand["sync.need_slow"]})
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == want
    assert tel["metrics"]["host_syncs_per_round"] == pytest.approx(
        sum(v for k, v in c.items() if k.startswith("sync.")) / tel["rounds"])
    for v in tel["summary"].values():
        assert 0 <= v["self_ms"] <= v["total_ms"]
    # the window's rounds: one lookup and one write call each
    calls = tel["summary"]["repro.facade.update" if kv else
                           "repro.facade.apply"]["calls"]
    assert calls == tel["rounds"]


def test_metrics_none_without_record():
    for f in tc.HOST_METRICS:
        assert f(None, 10) is None
    empty = types.SimpleNamespace(summary={}, counters={})
    assert tc.payload_host_ms_per_round(empty, 10) is None
    assert tc.slowpath_lane_share(empty) is None
    assert tc.hand_count(None, 64) is None


def test_idle_by_innermost_span():
    spans = [(0, 100, "a"), (10, 40, "b"), (20, 30, "c"), (60, 70, "b"),
             (120, 130, "d")]
    assert tc.innermost(spans) == [
        (0, 10, "a"), (10, 20, "b"), (20, 30, "c"), (30, 40, "b"),
        (40, 60, "a"), (60, 70, "b"), (70, 100, "a"), (120, 130, "d")]
    gaps = [(5, 25), (65, 110), (125, 140)]
    assert tc.idle_by_span(gaps, spans) == {"a": 5 + 30, "b": 10 + 5,
                                            "c": 5, "d": 5}


def test_cost_form(root):
    out = tc.cost("tiny-kv.b", 7, 2, 0.2, device="cpu", root=root)["cost"]
    assert len(out["ops_per_s"]["off"]) == len(out["ops_per_s"]["on"]) == 2
    assert min(out["ops_per_s"]["off"] + out["ops_per_s"]["on"]) > 0
