"""The table path's spans and counters (``repro_torch/telemetry.py``).

Off (no ``collect()``): a facade call records nothing, reads no clock of
the module and never enters the profiler. On: a schema ``Table.update``
gives the span tree of its facade call, payload stages, dispatch and
syncs, under one call id; ``slow.lanes`` equals the lanes the kernel's
plain version reported ``ST_FULL`` for; the ``sync.*`` counts equal a
hand count of the code from the slow path's calls and rounds; the
kernel wrappers' ``.launches`` deltas appear (0 on the CPU). The card
audit (``cuda``-marked, no JAX in this file) runs one round of each
benchmark cell's path under ``torch.cuda.set_sync_debug_mode("warn")``:
every synchronizing call torch reports on the table path is made inside
``host_read``/``host_write``, one for each ``sync.*`` count; on the CPU
the same holds of every ``.item()``, tensor truth value and scalar write:

    python -m pytest -q -m cuda tests/test_torch_telemetry.py
"""
import collections
import sys
import threading
import traceback
import types
import warnings

import pytest
import torch

from repro_torch import telemetry
from repro_torch.kernels import apply as kapply
from repro_torch.kernels.apply import ST_FROZEN, ST_FULL
from repro_torch.table_api import Table, TableSpec

SCHEMA = {"a": ("uint8", (8,)), "b": ("uint8", (4,))}


def schema_table(device="cpu", **kw):
    # 100 keys over 128 buckets of 8: no bucket is full
    geom = dict(dmax=12, bucket_size=8, pool_size=1024, n_lanes=64,
                initial_depth=7, slab_capacity=512)
    geom.update(kw)
    spec = TableSpec(value_schema=SCHEMA, backend="cuda", **geom)
    t = Table.create(spec, device=device)
    keys = torch.arange(1, 101, dtype=torch.int32, device=device)
    t, res = t.insert(keys, payload(keys, 0))
    assert (res.status == 1).all()
    return t, keys


def payload(keys, version):
    n = keys.shape[0]
    base = (keys.to(torch.int64) * 7 + version) % 251
    return {"a": (base[:, None] + torch.arange(8, device=keys.device))
            .to(torch.uint8),
            "b": (base[:, None] + torch.arange(4, device=keys.device))
            .to(torch.uint8).reshape(n, 4)}


def test_off_records_nothing_and_touches_no_clock(monkeypatch):
    t, keys = schema_table()

    def boom(*a, **kw):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(telemetry, "time",
                        types.SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", boom)
    assert telemetry.span("repro.a") is telemetry.span("repro.b")
    t, res = t.update(keys[:50], payload(keys[:50], 1))
    assert (res.status == 0).all()      # FALSE: present, updated
    found, got = t.lookup(keys[:50])
    assert found.all() and torch.equal(got["a"], payload(keys[:50], 1)["a"])
    telemetry.count("x")
    telemetry.count_device("y", keys)
    assert telemetry.host_read("z", keys.max()) == 100
    assert telemetry._record is None and not telemetry._ON


# the span tree of one schema Table.update of one transaction, in the
# order the spans open: (name, parent's name); on CPU tensors the plain
# fused_apply runs the wave loop, whose read is repro.sync.waves
UPDATE_TREE = [
    ("repro.facade.update", None),
    ("repro.facade.lookup", "repro.facade.update"),
    ("repro.dispatch.lookup", "repro.facade.lookup"),
    ("repro.facade.apply", "repro.facade.update"),
    ("repro.facade.txn", "repro.facade.apply"),
    ("repro.payload.lookup_before", "repro.facade.txn"),
    ("repro.dispatch.lookup", "repro.payload.lookup_before"),
    ("repro.payload.alloc", "repro.facade.txn"),
    ("repro.dispatch.apply", "repro.facade.txn"),
    ("repro.sync.waves", "repro.dispatch.apply"),
    ("repro.sync.applied", "repro.dispatch.apply"),
    ("repro.sync.need_slow", "repro.dispatch.apply"),
    ("repro.payload.write", "repro.facade.txn"),
    ("repro.payload.lookup_after", "repro.facade.txn"),
    ("repro.dispatch.lookup", "repro.payload.lookup_after"),
    ("repro.payload.reconcile", "repro.facade.txn"),
] + [("repro.sync.reconcile", "repro.payload.reconcile")] * 4


def test_span_tree_of_a_schema_update():
    t, keys = schema_table()
    with telemetry.collect() as rec:
        t, res = t.update(keys[:50], payload(keys[:50], 1))
    assert (res.status == 0).all()
    spans = rec.spans
    assert [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans] == UPDATE_TREE
    assert {s.call for s in spans} == {0}
    assert len({s.thread for s in spans}) == 1
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    for name, v in rec.summary.items():
        assert 0 <= v["self_ns"] <= v["total_ns"], name
        assert v["calls"] == sum(s.name == name for s in spans)
    assert rec.counters["sync.need_slow"] == rec.counters[
        "sync.applied"] == 1
    assert rec.counters["sync.reconcile"] == 4
    assert rec.counters["txn.live_lanes"] == 50
    assert rec.counters["slow.lanes"] == 0
    assert "slow.calls" not in rec.counters
    for k in ("fused_probe", "probe", "fused_apply", "grouped_apply"):
        assert rec.counters[f"kernel.{k}.launches"] == 0
    # a second call opens a new call id; the record is closed and fixed
    with telemetry.collect() as rec2:
        t.lookup(keys)
        t.lookup(keys)
    assert [s.call for s in rec2.spans if s.parent < 0] == [0, 1]
    assert len(rec.spans) == len(UPDATE_TREE)


def _spy(monkeypatch, name, kinds_at):
    """Wrap a kernel's plain version (its ops' kinds the positional
    argument ``kinds_at``); returns the list of its (kinds, status)."""
    seen = []
    fn = getattr(kapply, name)

    def spy(*args, **kw):
        out = fn(*args, **kw)
        seen.append((args[kinds_at].clone(), out[2].to(torch.int32).clone()))
        return out

    monkeypatch.setattr(kapply, name, spy)
    return seen


# a table meeting full buckets from its first transactions: the fused
# kernel (64 lanes) and the grouped kernel (1,100 lanes, past the fused
# bound), each over 2 small initial buckets
FULL_CASES = {
    "fused": (dict(dmax=12, bucket_size=4, pool_size=1024, n_lanes=64,
                   initial_depth=1), ("fused_apply_plain", 2), 192),
    "grouped": (dict(dmax=12, bucket_size=8, pool_size=2048, n_lanes=1100,
                     initial_depth=1), ("grouped_apply_plain", 0), 2200),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_slow_lanes_and_syncs_from_a_full_bucket(monkeypatch, case):
    geom, plain, n_keys = FULL_CASES[case]
    seen = _spy(monkeypatch, *plain)
    t = Table.create(TableSpec(backend="cuda", **geom), device="cpu")
    keys = torch.arange(1, n_keys + 1, dtype=torch.int32)
    gone = keys[::3].contiguous()
    with telemetry.collect() as rec:
        t, res = t.insert(keys, keys)
        t, res2 = t.delete(gone)
    assert (res.status == 1).all() and (res2.status == 1).all()
    c = rec.counters
    txns = len(seen)
    assert txns == rec.summary["repro.facade.txn"]["calls"] > 1
    full = sum(int((s == ST_FULL).sum()) for _, s in seen)
    live = sum(int(((k != 0) & (s != ST_FROZEN)).sum()) for k, s in seen)
    assert c["slow.lanes"] == full > 0
    assert c["txn.live_lanes"] == live == n_keys + len(gone)
    # the slow path's calls, each with its rounds (one wave pass a round)
    spans = rec.spans
    calls = [i for i, s in enumerate(spans)
             if s.name == "repro.core.apply_batch"]
    assert len(calls) == c["slow.calls"] > 0
    cfg = t.config

    def children(i, name):
        return sum(s.parent == i and s.name == name for s in spans)

    rounds = [children(i, "repro.sync.waves") for i in calls]
    assert sum(rounds) == c["slow.rounds"]
    for i, r in zip(calls, rounds):
        assert children(i, "repro.sync.pending") == r + (r < cfg.rounds)
    rounds, n_calls = c["slow.rounds"], c["slow.calls"]
    want = {"need_slow": txns, "applied": txns,
            "pending": rounds + n_calls,
            # + one wave loop a transaction in the kernel's plain version
            "waves": rounds + txns, "wave_pass": rounds,
            "split_pass": 2 * rounds, "splits": 9 * rounds,
            "fast_pass": n_calls if geom["n_lanes"] > 256 else 0}
    assert {k: c.get(f"sync.{k}", 0) for k in want} == want
    assert sum(v for k, v in c.items() if k.startswith("sync.")) == sum(
        want.values())
    for name, n in want.items():
        if n:
            assert rec.summary[f"repro.sync.{name}"]["calls"] == n


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_dir_writes_equal_the_hand_count(backend):
    """``slow.dir_writes`` equals a hand count from the final layout: no
    merge ran, so the split parents are the proper ancestors, at the
    initial depth or below it, of the live buckets, and each split
    rewrote its parent's whole range, Σ 2**(dmax - child depth) over its
    two children. ``Table.create`` builds the state in one
    ``repro.core.init_table`` span."""
    geom = dict(dmax=12, bucket_size=4, pool_size=1024, n_lanes=64,
                initial_depth=2)
    with telemetry.collect() as rec:
        t = Table.create(TableSpec(backend=backend, **geom), device="cpu")
        keys = torch.arange(1, 400, dtype=torch.int32)
        t, res = t.insert(keys, keys)
        t, res2 = t.delete(keys[::5].contiguous())
    assert (res.status == 1).all() and (res2.status == 1).all()
    st, dmax = t.state, geom["dmax"]
    parents = set()
    for b in torch.nonzero(st.live[:-1]).flatten().tolist():
        d, p = int(st.bdepth[b]), int(st.bprefix[b])
        parents |= {(p >> (d - j), j)
                    for j in range(geom["initial_depth"], d)}
    children = [(2 * p + c, j + 1) for p, j in parents for c in (0, 1)]
    c = rec.counters
    assert c["slow.dir_writes"] == sum(
        1 << (dmax - j) for _, j in children) > 0
    assert rec.summary["repro.core.init_table"]["calls"] == 1


def test_spans_reach_the_profiler_inside_collect_only():
    t, keys = schema_table()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t.lookup(keys)
    assert not any(e.name.startswith("repro.") for e in prof.events())
    with torch.profiler.profile(activities=acts) as prof:
        with telemetry.collect() as rec:
            t.lookup(keys)
    names = [e.name for e in prof.events() if e.name.startswith("repro.")]
    assert sorted(names) == sorted(s.name for s in rec.spans) == [
        "repro.dispatch.lookup", "repro.facade.lookup"]
    # a record without a profiler enters none
    with telemetry.collect() as rec:
        t.lookup(keys)
    assert len(rec.spans) == 2


def test_collect_is_not_reentrant_and_closes_on_error():
    with telemetry.collect():
        with pytest.raises(RuntimeError):
            with telemetry.collect():
                pass
    with pytest.raises(ValueError):
        with telemetry.collect() as rec:
            with telemetry.span("repro.test.outer"):
                telemetry.count("n", 2)
                raise ValueError
    assert not telemetry._ON
    assert rec.counters["n"] == 2 and rec.summary["repro.test.outer"][
        "calls"] == 1


def test_counters_and_spans_from_many_threads():
    """More threads than cores, a short switch interval: no count is lost,
    each thread's spans nest in its own stack under its own call ids."""
    n_threads, n = 32, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.collect() as rec:
            def work():
                for _ in range(n):
                    with telemetry.span("repro.test.outer"):
                        telemetry.count("hits")
                        with telemetry.span("repro.test.inner"):
                            telemetry.count("hits", 2)
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters["hits"] == 3 * n * n_threads
    spans = rec.spans
    assert rec.summary["repro.test.inner"]["calls"] == n * n_threads
    outer = [s for s in spans if s.name == "repro.test.outer"]
    assert all(s.parent < 0 for s in outer)
    assert len({s.call for s in outer}) == n * n_threads
    for s in spans:
        if s.name == "repro.test.inner":
            p = spans[s.parent]
            assert p.name == "repro.test.outer"
            assert (p.thread, p.call) == (s.thread, s.call)


def test_every_host_read_and_scalar_write_goes_through_telemetry(
        monkeypatch):
    """The CPU side of the sync audit: on the table path (a schema update
    that splits, a fused and a grouped transaction that split, lookups)
    every ``.item()``, ``bool``/``int`` of a tensor, ``.tolist()``,
    ``.cpu()`` and every ``x[i] = <Python scalar>`` (each a host sync on a
    CUDA tensor) is made inside ``telemetry.host_read`` or
    ``host_write``."""
    missed = []

    def caller():
        f = sys._getframe(2)
        return f.f_code.co_filename, f.f_lineno, f.f_code.co_name

    def on_path(where):
        return "repro_torch" in where[0] and not where[0].endswith(
            "telemetry.py")

    def guard(name, scalar_value=False):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *args):
            where = caller()
            if on_path(where) and (not scalar_value or isinstance(
                    args[-1], (bool, int, float))):
                missed.append((name,) + where)
            return orig(self, *args)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    # built before the guard: set-up writes its scalars once, off the path
    spec = TableSpec(value_schema=SCHEMA, backend="cuda", dmax=12,
                     bucket_size=8, pool_size=1024, n_lanes=64,
                     initial_depth=1, slab_capacity=512)
    tables = [(Table.create(spec, device="cpu"), 100)] + [
        (Table.create(TableSpec(backend="cuda", **FULL_CASES[c][0]),
                      device="cpu"), FULL_CASES[c][2])
        for c in ("fused", "grouped")]
    for name in ("item", "__bool__", "__int__", "__float__", "tolist",
                 "cpu"):
        guard(name)
    guard("__setitem__", scalar_value=True)

    with telemetry.collect() as rec:
        for t, n in tables:
            k = torch.arange(1, n + 1, dtype=torch.int32)
            v = payload(k, 0) if t.spec.value_schema else k
            t, _ = t.insert(k, v)                    # splits
            if t.spec.value_schema:
                t, _ = t.update(k, payload(k, 1))
            t.lookup(k)
    assert missed == []
    c = rec.counters
    assert c["slow.calls"] >= 3 and c["sync.splits"] > 0
    assert c["sync.reconcile"] > 0 and c["sync.fast_pass"] > 0


# ---------------------------------------------------------------------------
# the card audit of the host syncs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _audit(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")`` inside ``collect()``:
    (the syncs torch reports on the table path made inside
    ``telemetry.host_read``/``host_write``, those made elsewhere on it by
    site, the record)."""
    counted, missed = [0], collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if "repro_torch" in f.filename]
        if any(f.name in ("host_read", "host_write") for f in stack):
            counted[0] += 1
        elif stack:
            f = stack[-1]
            missed[f"{f.filename}:{f.lineno} {f.line}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with telemetry.collect() as rec:
                fn()
                torch.cuda.set_sync_debug_mode(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return counted[0], dict(missed), rec


@pytest.mark.cuda
def test_card_audit_schema_update(cuda):
    """One round of the ycsb cells' path: a lookup and a 4,096-record
    schema update (four fused 1,024-lane transactions) on a settled
    table."""
    spec = TableSpec(value_schema=SCHEMA, backend="cuda", dmax=16,
                     bucket_size=8, pool_size=2**15, n_lanes=1024,
                     initial_depth=12, slab_capacity=2**14)
    torch.manual_seed(0)
    t = Table.create(spec, device=cuda)
    keys = torch.randperm(2**20, device=cuda)[:8192].to(torch.int32) + 1
    t, res = t.insert(keys, payload(keys, 0))
    t, _ = t.update(keys, payload(keys, 1))      # settle: no slow path
    assert (res.status == 1).all()
    upd = keys[torch.randperm(8192, device=cuda)[:4096]]
    vals = payload(upd, 2)
    out = {}

    def round_():
        out["found"], _ = t.lookup(keys)
        out["t"], out["res"] = t.update(upd, vals)

    counted, missed, rec = _audit(round_)
    c = rec.counters
    assert c["kernel.fused_apply.launches"] == 4
    assert missed == {}
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.need_slow": 4, "sync.applied": 4, "sync.reconcile": 16}
    assert counted == 24 and c.get("slow.calls", 0) == 0
    assert (out["res"].status == 0).all() and out["found"].all()


@pytest.mark.cuda
def test_card_audit_grouped_apply_slow_path(cuda):
    """One write of the paper-int cell's path: a 4,096-lane
    ``grouped_apply`` transaction whose inserts meet full buckets, so the
    slow path runs its split rounds: in one ``resize_apply`` launch, with
    no host sync past the ``need_slow`` read, whatever the rounds."""
    torch.manual_seed(0)
    spec = TableSpec(backend="cuda", dmax=16, bucket_size=8,
                     pool_size=2**14, n_lanes=4096, initial_depth=8)
    t = Table.create(spec, device=cuda)
    keys = torch.randperm(2**24, device=cuda)[:8192].to(torch.int32) + 1
    t, _ = t.insert(keys[:4096], keys[:4096])
    kinds = torch.ones(4096, dtype=torch.int32, device=cuda)
    wkeys = keys[4096:]
    out = {}

    def write():
        out["t"], out["res"] = t.apply(kinds, wkeys, wkeys)

    counted, missed, rec = _audit(write)
    c = rec.counters
    assert c["kernel.grouped_apply.launches"] == 1
    assert c["kernel.resize_apply.launches"] == 1
    assert c["slow.calls"] == 1 and c["slow.lanes"] > 0
    assert c["slow.rounds"] >= 1 and c["slow.splits"] >= 1
    assert missed == {}
    assert {k: v for k, v in c.items() if k.startswith("sync.")} == {
        "sync.need_slow": 1, "sync.applied": 1}
    assert counted == 2
    assert (out["res"].status == 1).all()
