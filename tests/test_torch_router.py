"""The PyTorch port's serving router against the JAX package's.

The local half of ``tests/test_serving_router.py`` on the port (CPU): the
cost-model staircase, the measured cost model leaving the live table
alone, histogram percentiles, queue bounds and FIFO order, queue-full and
pressure shedding, pressure deferral, the adaptive-batching dispatch
points, and ``serve_closed_loop`` against its oracle with and without a
rolling upgrade. Then one request sequence with explicit times goes
through the JAX ``Router`` (``backend="xla"``) and the port's: every
request's result, the grouping into dispatches, the queue waits and the
counters are equal, across a handover in the middle. (Service times are
measured wall time, so they, and a closed loop's interleaving, differ
between the packages.)

The sharded half: the JAX side runs once in a subprocess with 8 forced
host devices on a mesh with automatic axes (the JAX sharded facade fails
under ``jax.make_mesh``'s default explicit axes, ``ROADMAP.md`` §3). A
2-shard router goes through ``_drive`` across a sharded -> local handover
in both packages with equal dispatch groups, results, queue waits,
per-shard shedding and counters; the JAX router's ``IndexError`` on a
submit after a local -> sharded handover (it keeps the predecessor's one
shard counter) is pinned beside the port's re-homed queues, whose results
equal the oracle; and both ``serve_closed_loop`` runs of the JAX package's
``test_closed_loop_sharded`` are ``ok`` in the port.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.policy import ResizePolicy as JaxPolicy
from repro.serving import router as JR
from repro.table_api import Table as JaxTable
from repro.table_api import TableSpec as JaxSpec
from repro_torch.core.policy import ResizePolicy
from repro_torch.core.reference import SeqExtHash
from repro_torch.serving.router import (DEL, INS, READ, SHED_PRESSURE,
                                        SHED_QUEUE_FULL, CostModel,
                                        LatencyHistogram, Request, Router,
                                        RouterConfig, ShardQueues,
                                        default_cost_model,
                                        measure_cost_model, shard_of)
from repro_torch.table_api import Table, TableSpec
from repro_torch.workloads import serve_closed_loop
from test_torch_dist import session_path
from test_torch_mesh_serving import BIGGER, COUNTERS, DRIVE_CFG, LOOP, SHARDED
from test_torch_mesh_serving import drive as _drive

jax.config.update("jax_platform_name", "cpu")

MINI = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8)
# the specs of the JAX package's closed-loop tests (LOOP, BIGGER) and
# LOOP's 8 aggregate hash bits over 2 shards (SHARDED), with the request
# sequence of the router tests (_drive), are test_torch_mesh_serving's
HERE = os.path.abspath(__file__)


# --- cost model -------------------------------------------------------------

def test_cost_model_staircase():
    m = CostModel(base_s=1e-3, chunk_s=1e-4, n_lanes=16)
    assert m.dispatch_cost(0) == 0.0
    assert m.dispatch_cost(1) == pytest.approx(1e-3 + 1e-4)
    assert m.dispatch_cost(16) == pytest.approx(1e-3 + 1e-4)
    assert m.dispatch_cost(17) == pytest.approx(1e-3 + 2e-4)
    assert m.throughput_ops_s(16) == pytest.approx(16 / (1e-3 + 1e-4))
    # batch_floor: whole chunks, grows with fixed overhead, >= one chunk
    assert m.batch_floor() % 16 == 0
    heavy = CostModel(base_s=1e-2, chunk_s=1e-4, n_lanes=16)
    assert heavy.batch_floor() > m.batch_floor()
    free = CostModel(base_s=0.0, chunk_s=1e-4, n_lanes=16)
    assert free.batch_floor() == 16
    for base, chunk in ((1e-3, 1e-4), (1e-2, 1e-4), (0.0, 3e-5)):
        j = JR.CostModel(base_s=base, chunk_s=chunk, n_lanes=16)
        p = CostModel(base_s=base, chunk_s=chunk, n_lanes=16)
        assert [p.batch_floor(s) for s in (0.5, 1.0, 4.0)] == [
            j.batch_floor(s) for s in (0.5, 1.0, 4.0)]
    with pytest.raises(ValueError):
        CostModel(base_s=0.0, chunk_s=0.0, n_lanes=16)
    with pytest.raises(ValueError):
        m.batch_floor(0.0)


def test_cost_model_measured_on_live_table():
    t = Table.create(TableSpec(**MINI), device="cpu")
    t, _ = t.insert([1, 2, 3], [10, 20, 30])
    m = measure_cost_model(t, max_chunks=4, repeats=2)
    assert m.source == "measured"
    assert m.n_lanes == 8 and m.chunk_s > 0 and m.base_s >= 0
    # measuring must not touch the live table
    assert int(t.size()) == 3 and t.seq == 1
    found, vals = t.lookup([1, 2, 3])
    assert found.all() and vals.tolist() == [10, 20, 30]
    # the router measures (once per spec, device and plan) when given none
    a = Router(t, RouterConfig())
    b = Router(t, RouterConfig())
    assert a.cost_model is b.cost_model and a.cost_model.source == "measured"


def test_cost_model_key_has_the_shard_count():
    """A 2-shard and a 4-shard table of the same ``dmax`` and pool are
    measured apart (the JAX key holds ``shard_bits``); the key also holds
    the mesh's shape, None off a mesh."""
    from repro.serving.router import costmodel as jcostmodel
    from repro_torch.serving.router import costmodel

    geom = dict(MINI, placement="sharded")
    t2 = Table.create(TableSpec(**geom, shard_bits=1), device="cpu")
    t4 = Table.create(TableSpec(**geom, shard_bits=2), device="cpu")
    k2, k4 = costmodel._cache_key(t2), costmodel._cache_key(t4)
    assert k2 != k4 and None in k2 and None in k4
    jkeys = [jcostmodel._cache_key(JaxSpec(**geom, shard_bits=b))
             for b in (1, 2)]
    assert jkeys[0] != jkeys[1]
    costmodel._CACHE.pop(k2, None)
    costmodel._CACHE.pop(k4, None)
    m2 = costmodel.cost_model_for(t2, max_chunks=2, repeats=1)
    m4 = costmodel.cost_model_for(t4, max_chunks=2, repeats=1)
    assert m2 is not m4
    assert costmodel._CACHE[k2] is m2 and costmodel._CACHE[k4] is m4


# --- latency histogram ------------------------------------------------------

def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    assert h.percentile(50) == 0.0 and h.summary() == {"count": 0}
    samples = np.linspace(1e-3, 10e-3, 1000)
    h.add_many(samples)
    s = h.summary()
    assert s["count"] == 1000
    # geometric buckets: ~12% relative error bound at 20/decade
    assert s["p50_ms"] == pytest.approx(5.5, rel=0.15)
    assert s["p99_ms"] == pytest.approx(9.9, rel=0.15)
    assert s["min_ms"] <= s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]
    assert s["max_ms"] == pytest.approx(10.0, rel=1e-6)
    j = JR.LatencyHistogram()
    j.add_many(samples)
    assert j.summary() == s
    with pytest.raises(ValueError):
        LatencyHistogram(lo=1.0, hi=0.5)


# --- shard queues -----------------------------------------------------------

def test_shard_queues_bound_and_fifo():
    q = ShardQueues(n_shards=2, max_depth_per_shard=3)
    reqs = [Request(rid=i, kind=INS if i % 2 else READ, key=i,
                    shard=i % 2, t_submit=float(i)) for i in range(8)]
    admitted = [q.admit(r) for r in reqs]
    # 3 per shard: rids 0..5 admitted, 6 (shard 0) and 7 (shard 1) shed
    assert admitted == [True] * 6 + [False, False]
    assert q.depth(0) == 3 and q.depth(1) == 3 and len(q) == 6
    assert q.oldest_wait(10.0) == pytest.approx(10.0)
    reads = q.take_reads(10)
    assert [r.rid for r in reads] == [0, 2, 4]
    writes = q.take_writes(2)
    assert [r.rid for r in writes] == [1, 3]
    assert q.depth(1) == 1 and len(q) == 1
    assert shard_of(12345, TableSpec(**MINI)) == 0
    with pytest.raises(ValueError):
        ShardQueues(n_shards=0, max_depth_per_shard=3)


# --- admission control ------------------------------------------------------

def _mini_router(max_queue=4, **cfg_kw):
    cfg = RouterConfig(max_batch=8, max_queue_per_shard=max_queue,
                       max_delay_s=1e-3, **cfg_kw)
    return Router(Table.create(TableSpec(**MINI), device="cpu"), cfg,
                  cost_model=default_cost_model(8), clock=lambda: 0.0)


def test_queue_full_shedding():
    r = _mini_router(max_queue=4)
    decisions = [r.submit(INS, k, k, now=0.0)[1] for k in range(1, 7)]
    assert decisions == ["admitted"] * 4 + [SHED_QUEUE_FULL] * 2
    assert r.metrics.shed_queue_full == 2
    done = r.flush(now=0.0)
    assert len(done) == 4 and all(d.status == 1 for d in done)


def test_pressure_sheds_writes_not_reads():
    r = _mini_router()
    r.pressure = 0.9                       # above pressure_shed
    _, dec_w = r.submit(INS, 1, 1, now=0.0)
    _, dec_r = r.submit(READ, 1, now=0.0)
    assert dec_w == SHED_PRESSURE and dec_r == "admitted"
    assert r.metrics.shed_pressure == 1


def test_pressure_defers_writes_behind_reads():
    r = _mini_router()
    r.submit(INS, 5, 50, now=0.0)
    r.submit(READ, 5, now=0.0)
    r.pressure = 0.5                       # defer < 0.5 < shed
    done = r.pump(now=0.0, force=True)
    # the read dispatched alone; the write is still queued
    assert [d.kind for d in done] == [READ]
    assert r.metrics.deferred_rounds == 1 and r.queues.n_writes == 1
    # deferral is bounded: once the write ages past max_delay it goes
    done = r.pump(now=1.0, force=True)
    assert [d.kind for d in done] == [INS] and done[0].status == 1


def test_adaptive_batching_dispatch_points():
    r = _mini_router(max_queue=64)
    # high fixed overhead => batch_floor caps at max_batch
    r.cost_model = default_cost_model(8, base_s=1e-2, chunk_s=1e-4)
    assert r.batch_floor == 8              # capped by max_batch
    r.submit(INS, 1, 1, now=0.0)
    assert r.pump(now=0.0) == []           # 1 < floor: hold
    assert len(r.pump(now=0.002)) == 1     # oldest aged past max_delay
    # a full floor's worth dispatches immediately
    for k in range(2, 10):
        r.submit(INS, k, k, now=0.01)
    assert len(r.pump(now=0.01)) == 8


@pytest.mark.parametrize("bad", [dict(max_batch=0), dict(max_delay_s=0.0),
                                 dict(pressure_defer=0.9, pressure_shed=0.5),
                                 dict(pressure_alpha=1.5)])
def test_router_validation_raises(bad):
    with pytest.raises(ValueError):
        RouterConfig(**bad)


def test_router_refuses_schemas_and_bad_kinds():
    schema = Table.create(TableSpec(**MINI, value_schema={"v": "int32"}),
                          device="cpu")
    with pytest.raises(ValueError, match="raw i32"):
        Router(schema, cost_model=default_cost_model(8))
    with pytest.raises(ValueError, match="kind"):
        _mini_router().submit(7, 1)
    # an infeasible handover target raises before the swap
    r = _mini_router(max_queue=64)
    for k in range(1, 40):
        r.submit(INS, k, k, now=0.0)
    r.flush(now=0.0)
    before = r.table
    with pytest.raises(ValueError):
        r.handover(TableSpec(dmax=2, bucket_size=2, pool_size=8, n_lanes=8))
    assert r.table is before and r.metrics.handovers == 0


# --- closed loop + parity ---------------------------------------------------

@pytest.mark.parametrize("seed,handover", [(7, False), (8, True)])
def test_closed_loop_parity(seed, handover):
    """The JAX package's closed-loop and rolling-upgrade tests on the port:
    every request against the oracle in linearization order, zero
    dropped."""
    spec = TableSpec(**LOOP, resize_policy=ResizePolicy())
    kw = dict(handover_at=0.5, handover_spec=TableSpec(
        **BIGGER, resize_policy=ResizePolicy())) if handover else {}
    rep = serve_closed_loop(
        spec, n_clients=6, ops_per_client=50, device="cpu", mix="churn",
        seed=seed, cost_model=default_cost_model(spec.n_lanes),
        router_config=RouterConfig(max_batch=16, max_delay_s=1e-3), **kw)
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["completed"] == rep["admitted"] == 300
    assert rep["status_mismatches"] == rep["content_mismatches"] == 0
    assert rep["total"]["count"] == 300
    assert rep["mean_batch"] > 1.0         # it actually batched
    assert rep["handover_done"] == handover
    assert rep["handovers"] == int(handover) and rep["dropped"] == 0
    with pytest.raises(ValueError):
        serve_closed_loop(spec, device="cpu", handover_at=0.5)


def test_router_matches_jax():
    cfg = DRIVE_CFG
    port = Router(Table.create(TableSpec(**LOOP,
                                         resize_policy=ResizePolicy()),
                               device="cpu"),
                  RouterConfig(**cfg), cost_model=default_cost_model(8))
    jax_router = JR.Router(
        JaxTable.create(JaxSpec(**LOOP, backend="xla",
                                resize_policy=JaxPolicy())),
        JR.RouterConfig(**cfg), cost_model=JR.default_cost_model(8))
    groups, rep, depths = _drive(port, TableSpec(
        **BIGGER, resize_policy=ResizePolicy()))
    jgroups, jrep, jdepths = _drive(jax_router, JaxSpec(
        **BIGGER, backend="xla", resize_policy=JaxPolicy()))
    assert groups == jgroups
    assert depths == jdepths
    assert len(groups) > 10 and rep["handovers"] == 1
    assert rep["shed_queue_full"] > 0 and rep["shed_pressure"] > 0
    assert rep["deferred_rounds"] > 0
    for k in COUNTERS:
        assert rep[k] == jrep[k], k
    assert rep["peak_pressure"] == pytest.approx(jrep["peak_pressure"],
                                                 abs=1e-4)
    assert rep["cost_model"] == jrep["cost_model"]
    assert rep["config"] == jrep["config"]


# --- the sharded half ---------------------------------------------------------

def _jax_sharded_main(out_path):
    """The JAX side of the sharded tests (8 forced host devices)."""
    from jax.sharding import AxisType

    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    r = JR.Router(JaxTable.create(JaxSpec(**SHARDED, backend="xla",
                                          resize_policy=JaxPolicy()), mesh),
                  JR.RouterConfig(**DRIVE_CFG),
                  cost_model=JR.default_cost_model(8))
    groups, rep, depths = _drive(r, JaxSpec(**BIGGER, backend="xla",
                                            resize_policy=JaxPolicy()))
    out["groups"], out["depths"] = groups, depths
    out["report"] = {k: rep[k] for k in COUNTERS + ("peak_pressure",)}
    # the fault: a local router handed over onto a sharded table keeps its
    # one shard counter, and a submit homed on shard 1 indexes past it
    r = JR.Router(JaxTable.create(JaxSpec(**LOOP, backend="xla")),
                  JR.RouterConfig(max_queue_per_shard=64),
                  cost_model=JR.default_cost_model(8))
    for k in range(1, 9):
        r.submit(INS, k, k, now=0.0)
    r.handover(JaxSpec(**SHARDED, backend="xla"), mesh, warmup=False)
    out["fault"] = None
    for k in range(100, 200):
        try:
            r.submit(INS, k, k, now=0.0)
        except IndexError as e:
            out["fault"] = {"key": k, "error": repr(e),
                            "depths": r.queues.depths()}
            break
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("jax side OK")
    return 0


def _make_jax_sharded(path):
    tmp = path + ".part"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(
                   HERE)), "src"))
    proc = subprocess.run([sys.executable, HERE, "--jax-sharded", tmp],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    os.replace(tmp, path)


def shared_jax_sharded(tmp_path_factory):
    """The JAX sharded router's run, made once per test session
    (``tests/test_torch_mesh_serving.py`` reads the same file)."""
    with open(session_path(tmp_path_factory, "jax_router.json",
                           _make_jax_sharded)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    return shared_jax_sharded(tmp_path_factory)


def test_sharded_router_matches_jax(jax_sharded):
    """A 2-shard router across a sharded -> local handover: dispatch
    groups, results, queue waits, per-shard shedding and counters equal the
    JAX router's; before the handover both count two shards, after it the
    port counts one (re-homed), the JAX router still two."""
    port = Router(Table.create(TableSpec(**SHARDED,
                                         resize_policy=ResizePolicy()),
                               device="cpu"),
                  RouterConfig(**DRIVE_CFG), cost_model=default_cost_model(8))
    assert port.queues.n_shards == 2
    groups, rep, depths = _drive(port, TableSpec(
        **BIGGER, resize_policy=ResizePolicy()))
    assert json.loads(json.dumps(groups)) == jax_sharded["groups"]
    assert len(groups) > 10 and rep["handovers"] == 1
    assert rep["shed_queue_full"] > 0 and rep["shed_pressure"] > 0
    for k in COUNTERS:
        assert rep[k] == jax_sharded["report"][k], k
    assert rep["peak_pressure"] == pytest.approx(
        jax_sharded["report"]["peak_pressure"], abs=1e-4)
    before, after = depths
    assert before == jax_sharded["depths"][0] and len(before) == 2
    assert min(before) > 0                 # both shards had queued work
    assert after == [sum(before)]
    assert jax_sharded["depths"][1] == before


def test_local_to_sharded_handover_rehomes_queues(jax_sharded):
    """The JAX router raises ``IndexError`` on the first submit homed on
    shard 1 after a local -> sharded handover; the port re-homes the queued
    requests (each per-shard depth equals a recount by home shard), keeps
    admitting, and every result equals the oracle in linearization
    order."""
    fault = jax_sharded["fault"]
    assert fault is not None and "IndexError" in fault["error"]
    assert fault["depths"] == [8]          # still the one local counter
    succ = TableSpec(**SHARDED)
    assert shard_of(fault["key"], succ) == 1
    assert all(shard_of(k, succ) == 0 for k in range(100, fault["key"]))

    r = Router(Table.create(TableSpec(**LOOP), device="cpu"),
               RouterConfig(max_batch=16, max_queue_per_shard=64),
               cost_model=default_cost_model(8))
    rng = np.random.default_rng(4)
    done = []

    def submit(n, now):
        for _ in range(n):
            kind = int(rng.choice([READ, INS, INS, DEL]))
            req, _ = r.submit(kind, int(rng.integers(1, 300)),
                              int(rng.integers(1, 1 << 20)), now=now)
            assert req is not None

    submit(40, 0.0)
    done += r.pump(now=0.0, force=True)
    submit(30, 1e-3)
    queued = [q for q in list(r.queues._reads) + list(r.queues._writes)]
    r.handover(succ)
    assert r.queues.n_shards == 2
    want = [sum(shard_of(q.key, succ) == s for q in queued) for s in (0, 1)]
    assert r.queues.depths() == want and min(want) > 0
    assert all(q.shard == shard_of(q.key, succ) for q in queued)
    submit(60, 2e-3)                       # shard-1 homes among them
    done += r.flush(now=3e-3)
    assert len(done) == 130 and r.metrics.dropped == 0
    ref = SeqExtHash(dmax=8, bucket_size=8)
    for q in done:
        if q.kind == INS:
            assert q.status == ref.insert(q.key, q.value), q
        elif q.kind == DEL:
            assert q.status == ref.delete(q.key), q
        else:
            found, val = ref.lookup(q.key)
            assert (q.found, q.result) == (found, val if found else None), q


@pytest.mark.parametrize("seed,handover", [(9, False), (10, True)])
def test_closed_loop_sharded(seed, handover):
    """The two runs of the JAX package's ``test_closed_loop_sharded`` on
    the port: a 2-shard table, then the same handed over onto a local
    successor at the same aggregate bits halfway."""
    spec = TableSpec(dmax=8, bucket_size=8, pool_size=256, n_lanes=8,
                     placement="sharded", shard_bits=1,
                     resize_policy=ResizePolicy())
    kw = dict(handover_at=0.5, handover_spec=TableSpec(
        dmax=9, bucket_size=8, pool_size=512, n_lanes=8,
        resize_policy=ResizePolicy())) if handover else {}
    rep = serve_closed_loop(
        spec, n_clients=4, ops_per_client=30, mix="churn", seed=seed,
        device="cpu", cost_model=default_cost_model(spec.n_lanes),
        router_config=RouterConfig(max_batch=16, max_delay_s=1e-3), **kw)
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["completed"] == rep["admitted"] == 120
    assert rep["handover_done"] == handover and rep["dropped"] == 0
    assert len(rep["queue_depths"]) == (1 if handover else 2)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-sharded", sys.argv
    sys.exit(_jax_sharded_main(sys.argv[2]))
