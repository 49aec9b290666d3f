"""The PyTorch port's serving router, closed-loop driver and chaos harness
on a device mesh of gloo ranks, against the JAX package's sharded router
and chaos run, and every rank against rank 0.

One world of four processes of this file, joined through a ``FileStore``
(no TCP port), runs once per test session in its temporary root. Each
rank has a time limit, and the process group's own timeout turns a
collective that waits too long into an error, so a hang fails the file.
Every rank makes the same calls with the same global streams, and writes
what it reads back:

* ``drive`` (the request sequence of ``tests/test_torch_router.py``) on
  a 2-shard table on the ``(2, 2)`` mesh, handed over onto a local
  replica: its dispatch groups and counters must equal the JAX sharded
  router's (the session's JAX run of ``test_torch_router.py``);
* the same sequence with the router's ``time.perf_counter`` and the cost
  model's clock skewed by rank: each rank's own fit differs, yet every
  rank's groups and report (latency percentiles and cost model included)
  equal rank 0's, one agreement broadcast per dispatch;
* ``serve_closed_loop`` on 4 shards over ``(1, 4)``, handed over onto 2
  shards over ``(2, 2)`` and onto a local replica;
* ``chaos_replay`` of ``chaos_reshard`` (seed 5, scale 0.3) starting on
  ``default_mesh_for(2)`` with ``mesh_for=default_mesh_for``: statuses,
  lookups, digests and event records must equal the JAX 8-device run's
  (the session's JAX run of ``test_torch_chaos.py``);
* forced moves over 2 / 4 / 8 shards (8 shards two a rank on ``(1, 4)``)
  and local, with ``kill_revive`` on the mesh and on the replica and
  ``torn_save`` on the mesh, every image written by rank 0 alone;
* a save whose write fails on rank 0 (the fault hook): every rank raises
  ``InjectedFault`` and the image that survives is intact; a replay whose
  revives land on a local table saves it from rank 0 alone; the cost
  model's key holds the mesh's shape.

The JAX package's ``default_mesh_for`` shapes over 8 devices come from
the same JAX subprocess as its chaos run.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.abspath(os.path.join(os.path.dirname(HERE), "..", "src"))
WORLD = 4
RANK_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 120

# the router tests' specs (tests/test_torch_router.py)
LOOP = dict(dmax=8, bucket_size=8, pool_size=512, n_lanes=8)
BIGGER = dict(dmax=9, bucket_size=8, pool_size=1024, n_lanes=8)
# LOOP's 8 aggregate hash bits over 2 shards
SHARDED = dict(LOOP, dmax=7, placement="sharded", shard_bits=1)
# low pressure thresholds, so that the policy's pressure defers and sheds
# writes in the short sequences of drive
DRIVE_CFG = dict(max_batch=16, max_queue_per_shard=24, max_delay_s=1e-3,
                 pressure_defer=0.15, pressure_shed=0.25)
COUNTERS = ("submitted", "admitted", "completed", "shed_queue_full",
            "shed_pressure", "dispatches", "dispatched_ops", "lookup_ops",
            "deferred_rounds", "maintenance_rounds", "handovers", "dropped",
            "mean_batch", "queue_wait")
# (kind, candidate index) of the forced moves: 4 shards, 8 by handover,
# a kill/revive of the mesh table two shards a rank, local, a kill/revive
# of the local replica, 8 shards, a torn save two shards a rank, 4 shards
# with the larger pool
MOVES = (("reshard", 4), ("handover", 6), ("kill_revive", 0),
         ("reshard", 0), ("kill_revive", 0), ("reshard", 7),
         ("torn_save", 0), ("reshard", 5))
LOOP_RUNS = ("2x2", "local")


# ---------------------------------------------------------------------------
# helpers shared with tests/test_torch_router.py and test_torch_chaos.py
# (no JAX import here: the ranks import this file)


def drive(router, handover_spec, seed=21, mesh=None):
    """A seeded request sequence with explicit times: 5 requests every
    0.4 ms (a burst of 30, past the queue bound, every 15th time), a pump
    after each, a handover halfway (with requests queued; ``mesh`` is the
    successor's), then forced pumps until the queues drain. Returns the
    dispatch groups as (rid, kind, key, status, found, result) tuples, the
    report and the per-shard queue depths just before and just after the
    handover. Either package's router."""
    from repro_torch.serving.router import DEL, INS, READ

    rng = np.random.default_rng(seed)
    groups, depths = [], []

    def take(done):
        if done:
            groups.append([(q.rid, q.kind, q.key, q.status, q.found, q.result)
                           for q in done])

    now = 0.0
    for tick in range(60):
        for _ in range(30 if tick % 15 == 7 else 5):
            kind = int(rng.choice([READ, READ, INS, INS, DEL]))
            key = int(rng.integers(1, 160))
            router.submit(kind, key, int(rng.integers(1, 1 << 20)), now=now)
        if tick == 30:
            assert len(router.queues) > 0
            depths.append(router.queues.depths())
            if mesh is None:
                router.handover(handover_spec)
            else:
                router.handover(handover_spec, mesh=mesh)
            depths.append(router.queues.depths())
        take(router.pump(now=now))
        now += 4e-4
    while len(router.queues):
        take(router.pump(now=now, force=True))
        now += 1e-3
    return groups, router.report(), depths


def recorded_run(mod, table_cls, monkeypatch, *args, **kw):
    """``mod.chaos_replay(*args, **kw)`` with every step's statuses and
    reads (``Table.apply``/``lookup`` on that step's own arrays) and every
    content digest the harness computes recorded, as numpy. Either
    package's harness."""
    log = {"apply": [], "lookup": [], "digest": []}
    step = [None]
    gen_steps, apply, lookup = mod.gen_steps, table_cls.apply, table_cls.lookup
    content_digest = mod.content_digest

    def steps(trace):
        for s in gen_steps(trace):
            step[0] = s
            yield s

    def rec_apply(self, kinds, keys, values=None):
        out = apply(self, kinds, keys, values)
        if step[0] is not None and keys is step[0].keys:
            log["apply"].append(np.asarray(out[1].status).astype(np.int8))
        return out

    def rec_lookup(self, keys):
        found, vals = lookup(self, keys)
        if step[0] is not None and keys is step[0].reads:
            f = np.asarray(found)
            log["lookup"].append((f, np.where(f, np.asarray(vals), 0)))
        return found, vals

    def rec_digest(keys, values):
        d = content_digest(keys, values)
        log["digest"].append(d)
        return d

    monkeypatch.setattr(mod, "gen_steps", steps)
    monkeypatch.setattr(mod, "content_digest", rec_digest)
    monkeypatch.setattr(table_cls, "apply", rec_apply)
    monkeypatch.setattr(table_cls, "lookup", rec_lookup)
    try:
        rep = mod.chaos_replay(*args, **kw)
    finally:
        monkeypatch.undo()
    return rep, log


# ---------------------------------------------------------------------------
# the ranks (subprocesses of this file)


def _mesh_for(n):
    from repro_torch.workloads.chaos import default_mesh_for
    return default_mesh_for(n, 16, "cpu")


class _SaveCounter:
    """A snapshot fault hook that counts this rank's image writes."""

    def __init__(self):
        self.writes = 0

    def __call__(self, point, path):
        self.writes += point == "pre_rename"


def _router_runs(rank, mesh22):
    from repro_torch.core.policy import ResizePolicy
    from repro_torch.serving.router import (Router, RouterConfig,
                                            default_cost_model,
                                            measure_cost_model)
    from repro_torch.serving.router import router as router_mod
    from repro_torch.table_api import Table, TableSpec

    def table():
        return Table.create(TableSpec(**SHARDED,
                                      resize_policy=ResizePolicy()),
                            "cpu", mesh22)

    bigger = TableSpec(**BIGGER, resize_policy=ResizePolicy())
    out = {}
    r = Router(table(), RouterConfig(**DRIVE_CFG),
               cost_model=default_cost_model(8))
    groups, rep, depths = drive(r, bigger)
    out["drive"] = {"groups": groups, "report": rep, "depths": depths,
                    "mesh_after": r.mesh is mesh22,
                    "local_after": r.table.mesh is None}

    # every host clock skewed by rank: rank r's runs 1 + 3r times as fast
    real = time.perf_counter

    def skewed():
        return real() * (1 + 3 * rank) + 1e3 * rank

    t = table()
    own = measure_cost_model(Table.create(TableSpec(**SHARDED), "cpu"),
                             max_chunks=2, repeats=1, clock=skewed)
    cost = measure_cost_model(t, max_chunks=2, repeats=1, clock=skewed)
    saved = router_mod.time
    router_mod.time = type("SkewedTime", (), {
        "perf_counter": staticmethod(skewed)})
    try:
        groups, rep, _ = drive(Router(t, RouterConfig(**DRIVE_CFG),
                                      cost_model=cost), bigger)
    finally:
        router_mod.time = saved
    out["skewed"] = {"groups": groups, "report": rep,
                     "own_fit": [own.base_s, own.chunk_s]}
    return out


def _loop_runs(mesh14, mesh22):
    from repro_torch.core.policy import ResizePolicy
    from repro_torch.serving.router import RouterConfig, default_cost_model
    from repro_torch.table_api import TableSpec
    from repro_torch.workloads import serve_closed_loop

    geom = dict(bucket_size=8, n_lanes=8, resize_policy=ResizePolicy())
    spec4 = TableSpec(dmax=6, pool_size=256, placement="sharded",
                      shard_bits=2, **geom)
    targets = {"2x2": (TableSpec(dmax=7, pool_size=512, placement="sharded",
                                 shard_bits=1, **geom), mesh22),
               "local": (TableSpec(dmax=8, pool_size=1024, **geom), None)}
    out = {}
    for i, name in enumerate(LOOP_RUNS):
        spec, hmesh = targets[name]
        rep = serve_closed_loop(
            spec4, n_clients=4, ops_per_client=30, mix="churn", seed=11 + i,
            device="cpu", mesh=mesh14, handover_mesh=hmesh,
            handover_at=0.5, handover_spec=spec,
            # the first run measures its cost model on the mesh
            cost_model=None if i == 0 else default_cost_model(8),
            router_config=RouterConfig(max_batch=16, max_delay_s=1e-3))
        out[name] = rep
    return out


def _chaos_runs(mesh22):
    from repro_torch.core import snapshot as S
    from repro_torch.table_api import Table
    from repro_torch.workloads import chaos as C

    spec, trace, schedule = C.chaos_setup("chaos_reshard",
                                          placement="sharded", seed=5,
                                          scale=0.3)
    rep, log = recorded_run(C, Table, pytest.MonkeyPatch(), spec, trace,
                            schedule, device="cpu", mesh=_mesh_for(2),
                            mesh_for=_mesh_for, raise_on_mismatch=False)
    out = {"jax_schedule": {
        "rep": rep, "apply": [a.tolist() for a in log["apply"]],
        "lookup": [(f.tolist(), v.tolist()) for f, v in log["lookup"]],
        "digest": log["digest"]}}

    # a run that starts local: the run's mesh is mesh_for's first
    lspec, ltrace, lsched = C.chaos_setup("chaos_reshard", placement="local",
                                          seed=5, scale=0.3)
    out["local_start"] = C.chaos_replay(lspec, ltrace, lsched, device="cpu",
                                        mesh_for=_mesh_for,
                                        raise_on_mismatch=False)

    cands = C._respec_candidates(spec, mesh22, _mesh_for)
    n = trace.total_steps
    forced = tuple(C.ChaosEvent(n * (i + 1) // (len(MOVES) + 1), kind, arg)
                   for i, (kind, arg) in enumerate(MOVES))
    counter = _SaveCounter()
    prev = S.set_fault_hook(counter)
    try:
        rep = C.chaos_replay(spec, trace, forced, device="cpu", mesh=mesh22,
                             mesh_for=_mesh_for, oracle="both",
                             raise_on_mismatch=False)
    finally:
        S.set_fault_hook(prev)
    out["forced"] = {
        "rep": rep, "writes": counter.writes,
        "candidates": [[c.n_shards if c.placement == "sharded" else 1,
                        None if m is None else list(m.mesh.shape)]
                       for c, m in cands]}
    out["mesh_shapes"] = {str(k): list(_mesh_for(k).mesh.shape)
                          for k in (2, 4, 8)}
    out["mesh_builds"] = C.default_mesh_for.builds
    return out


def _save_failures(mesh22):
    """A mesh table's save and a local replica's, each failing in rank
    0's write: the exception's class name on this rank, the survivor's
    digest against the intact image's, and a collective after it."""
    from repro_torch.core import snapshot as S
    from repro_torch.core.reference import content_digest
    from repro_torch.table_api import Table, TableSpec
    from repro_torch.workloads.replay import _shared_dir

    def boom(point, path):
        if point == "pre_rename":
            raise S.InjectedFault(f"injected crash before rename of {path}")

    keys = np.arange(1, 200, dtype=np.int32)
    out = {}
    with _shared_dir(mesh22) as td:
        for name, t, mesh in (
                ("mesh", Table.create(TableSpec(**SHARDED), "cpu", mesh22),
                 None),
                ("replica", Table.create(TableSpec(**LOOP), "cpu"), mesh22)):
            t, _ = t.insert(keys, keys * 3)
            path = t.save(os.path.join(td, f"{name}.npz"), mesh)
            img = S.load_image(path)
            want = content_digest(img.keys, img.values)
            prev = S.set_fault_hook(boom)
            try:
                t.save(path, mesh)
                raised = None
            except Exception as e:  # noqa: BLE001 — the class is the result
                raised = type(e).__name__
            finally:
                S.set_fault_hook(prev)
            img = S.load_image(path)
            out[name] = {"raised": raised,
                         "intact": content_digest(img.keys, img.values)
                         == want,
                         "tmp_left": os.path.exists(path + ".tmp"),
                         "size_after": int(t.size())}
    return out


def _replay_writers(mesh22):
    from repro_torch.core import snapshot as S
    from repro_torch.workloads import get_scenario, replay

    spec, trace = get_scenario("snapshot_restore", placement="sharded",
                               scale=0.25)
    local = dataclasses.replace(spec, placement="local",
                                dmax=spec.dmax + spec.shard_bits)
    counter = _SaveCounter()
    prev = S.set_fault_hook(counter)
    try:
        rep = replay(spec, trace, device="cpu", oracle="both",
                     raise_on_mismatch=False, restore_spec=local,
                     mesh=mesh22)
    finally:
        S.set_fault_hook(prev)
    return {"ok": rep["ok"], "restores": rep["snapshot_restores"],
            "writes": counter.writes,
            "mismatches": [rep["status_mismatches"],
                           rep["content_mismatches"]]}


def _cost_keys(mesh22):
    from repro_torch.serving.router.costmodel import _cache_key
    from repro_torch.table_api import Table, TableSpec

    spec = TableSpec(**SHARDED)
    km = _cache_key(Table.create(spec, "cpu", mesh22))
    ks = _cache_key(Table.create(spec, "cpu"))
    return {"mesh_shape": list(km[8]), "stacked_shape": ks[8],
            "differ": km != ks}


def _rank_main(rank, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh22, mesh14 = _mesh_for(2), _mesh_for(4)
        out = {"router": _router_runs(rank, mesh22),
               "loop": _loop_runs(mesh14, mesh22),
               "chaos": _chaos_runs(mesh22),
               "replay": _replay_writers(mesh22),
               "cost_keys": _cost_keys(mesh22),
               # last: a failing save must leave no rank behind
               "save": _save_failures(mesh22)}
        with open(os.path.join(tmp, f"r{rank}.json"), "w") as f:
            json.dump(out, f, default=lambda o: o.item())
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the fixtures


def _start_ranks(path):
    part = path + ".part"
    os.makedirs(part, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(r), part], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(WORLD)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, (p.args, out[-2000:], err[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    os.replace(part, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from the world that runs once per session."""
    from test_torch_dist import session_path

    path = session_path(tmp_path_factory, "mesh_serving", _start_ranks)
    out = []
    for r in range(WORLD):
        with open(os.path.join(path, f"r{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def jax_router(tmp_path_factory):
    from test_torch_router import shared_jax_sharded
    return shared_jax_sharded(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_chaos(tmp_path_factory):
    from test_torch_chaos import shared_jax_chaos
    return shared_jax_chaos(tmp_path_factory)


def same_on_every_rank(ranks, *keys):
    got = ranks[0]
    for k in keys:
        got = got[k]
    for r, other in enumerate(ranks[1:], 1):
        x = other
        for k in keys:
            x = x[k]
        assert x == got, (r, keys)
    return got


# ---------------------------------------------------------------------------
# the router and the closed loop


def test_mesh_router_matches_jax(ranks, jax_router):
    """``drive`` on a 2-shard table over ``(2, 2)``, handed over onto a
    local replica: the dispatch groups, results, queue waits, per-shard
    shedding and counters equal the JAX sharded router's, on every rank;
    the router keeps the run's mesh after the handover and agrees one
    service time a dispatch."""
    run = same_on_every_rank(ranks, "router", "drive")
    assert run["groups"] == jax_router["groups"]
    assert len(run["groups"]) > 10
    rep = run["report"]
    for k in COUNTERS:
        assert rep[k] == jax_router["report"][k], k
    assert rep["peak_pressure"] == pytest.approx(
        jax_router["report"]["peak_pressure"], abs=1e-4)
    assert rep["handovers"] == 1 and rep["shed_queue_full"] > 0
    before, after = run["depths"]
    assert before == jax_router["depths"][0] and len(before) == 2
    assert after == [sum(before)]
    assert run["mesh_after"] and run["local_after"]
    assert rep["agreement_broadcasts"] == rep["dispatches"]


def test_mesh_router_agrees_under_skewed_clocks(ranks):
    """Every host clock skewed by rank: each rank's own cost-model fit
    differs, yet the mesh router's groups and whole report (latency
    percentiles and cost model included) equal rank 0's on every rank."""
    fits = [r["router"]["skewed"]["own_fit"] for r in ranks]
    assert len({tuple(f) for f in fits}) == WORLD, fits
    same_on_every_rank(ranks, "router", "skewed", "groups")
    rep = same_on_every_rank(ranks, "router", "skewed", "report")
    assert rep["cost_model"]["source"] == "measured"
    assert rep["total"]["count"] == rep["completed"] > 0
    assert rep["agreement_broadcasts"] == rep["dispatches"]
    assert rep["busy_s"] > 0


@pytest.mark.parametrize("name", LOOP_RUNS)
def test_mesh_closed_loop_handover(ranks, name):
    """``serve_closed_loop`` on 4 shards over ``(1, 4)`` handed over onto
    2 shards over ``(2, 2)`` (an N -> M move) or onto a local replica:
    ``ok``, every request completed, none dropped, one agreement broadcast
    a dispatch, the same report on every rank."""
    rep = same_on_every_rank(ranks, "loop", name)
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["completed"] == rep["admitted"] == 120
    assert rep["handovers"] == 1 and rep["dropped"] == 0
    assert rep["handover_done"]
    assert len(rep["queue_depths"]) == (2 if name == "2x2" else 1)
    assert rep["agreement_broadcasts"] == rep["dispatches"]


# ---------------------------------------------------------------------------
# chaos


def test_mesh_chaos_matches_jax(ranks, jax_chaos):
    """``chaos_reshard`` (seed 5, scale 0.3) from ``default_mesh_for(2)``
    with ``mesh_for=default_mesh_for`` on four ranks: step by step and
    event by event the JAX run on 8 devices, on every rank."""
    run = same_on_every_rank(ranks, "chaos", "jax_schedule")
    rep, jrep = run["rep"], jax_chaos["rep"]
    assert rep["ok"] and jrep["ok"], (rep["mismatch_examples"],
                                      jrep["mismatch_examples"])
    assert run["apply"] == jax_chaos["apply"]
    assert len(run["apply"]) == rep["steps"]
    assert run["lookup"] == jax_chaos["lookup"]
    assert run["digest"] == jax_chaos["digest"]
    fields = ("step", "kind", "arg", "skipped", "n_items", "digest_ok", "to",
              "policy", "image_intact", "invariant_shards")
    assert ([{k: r.get(k) for k in fields} for r in rep["events"]]
            == [{k: r.get(k) for k in fields} for r in jrep["events"]])
    for k in ("steps", "mutations", "reads", "event_counts", "error_flag",
              "events_skipped", "placement", "depth", "policy"):
        assert rep[k] == jrep[k], k
    placements = {r["to"]["placement"] for r in rep["events"] if "to" in r}
    assert placements == {"local", "sharded"}


def test_mesh_chaos_from_a_local_start(ranks):
    """``chaos_reshard`` from a local table (a replica on every rank) with
    ``mesh_for=default_mesh_for``: its handover lands on the ``(2, 2)``
    mesh, and the run is clean and the same on every rank."""
    rep = same_on_every_rank(ranks, "chaos", "local_start")
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["events_skipped"] == 0 and not rep["error_flag"]
    moves = [r["to"]["placement"] for r in rep["events"] if "to" in r]
    assert "sharded" in moves
    assert {r["invariant_shards"] for r in rep["events"]} >= {1, 2}


def test_mesh_chaos_moves_to_4_and_8_shards(ranks):
    """Forced re-shards and a handover over 2 / 4 / 8 shards (8 shards two
    a rank on ``(1, 4)``) and a local replica, with a kill/revive of the
    mesh table and of the replica and a torn save of the mesh table: every
    digest equals the oracle's, the invariants hold on every rank's shards
    and the gathered stack, and rank 0 alone writes each image."""
    run = ranks[0]["chaos"]["forced"]
    same_on_every_rank(ranks, "chaos", "forced", "candidates")
    same_on_every_rank(ranks, "chaos", "forced", "rep")
    assert run["candidates"] == [[1, None], [1, None], [2, [2, 2]],
                                 [2, [2, 2]], [4, [1, 4]], [4, [1, 4]],
                                 [8, [1, 4]], [8, [1, 4]]]
    rep = run["rep"]
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["events_skipped"] == 0 and not rep["error_flag"]
    events = rep["events"]
    assert [r["kind"] for r in events] == [k for k, _ in MOVES]
    assert ([r["invariant_shards"] for r in events]
            == [4, 8, 8, 1, 1, 8, 8, 4])
    assert all(r["digest_ok"] and not r["skipped"] for r in events)
    torn = next(r for r in events if r["kind"] == "torn_save")
    assert torn["image_intact"]
    handover = next(r for r in events if r["kind"] == "handover")
    assert handover["router_events"] == ["handover_begin", "handover_end"]
    # reshards 4 + kill/revives 2 + the torn save's intact image 1
    assert [r["chaos"]["forced"]["writes"] for r in ranks] == [7, 0, 0, 0]
    # each mesh shape built once over the whole world's run
    assert [r["chaos"]["mesh_builds"] for r in ranks] == [2] * WORLD
    assert ranks[0]["chaos"]["mesh_shapes"] == {"2": [2, 2], "4": [1, 4],
                                                "8": [1, 4]}


def test_default_mesh_for_matches_jax(jax_chaos):
    """The port's mesh shapes over 8 ranks against the JAX package's
    factory over 8 devices, for 1-16 shards and 1-16 lanes: equal wherever
    JAX builds a mesh; where it has too few devices (16 shards) the port
    puts two shards on each of 8 ranks."""
    from repro_torch.workloads.chaos import _mesh_shape

    diverged = []
    for key, jshape in jax_chaos["mesh_shapes"].items():
        n, lanes = map(int, key.split(","))
        ours = _mesh_shape(n, lanes, 8)
        if jshape is not None:
            assert ours == tuple(jshape), key
        elif ours is not None:
            diverged.append((n, lanes, ours))
    assert diverged == [(16, lanes, (1, 8)) for lanes in range(1, 17)]
    assert sum(s is not None for s in jax_chaos["mesh_shapes"].values()) > 10


# ---------------------------------------------------------------------------
# the repairs


def test_mesh_save_failure_raises_on_every_rank(ranks):
    """Rank 0's write of a mesh table's image, and of a local replica's,
    dies before its rename: every rank raises ``InjectedFault`` (none is
    left at a barrier), the image on disk is the intact one, and the ranks
    go on to the next collective together."""
    got = same_on_every_rank(ranks, "save")
    for name in ("mesh", "replica"):
        assert got[name] == {"raised": "InjectedFault", "intact": True,
                             "tmp_left": True, "size_after": 199}, name


def test_mesh_replay_local_revives_have_one_writer(ranks):
    """``replay`` on ``(2, 2)`` with a local ``restore_spec``: after the
    first revive each rank holds a local replica, and the second revive's
    image is written by rank 0 alone (no two writers on one file)."""
    got = same_on_every_rank(ranks, "replay", "restores")
    assert got == 2
    for r in ranks:
        assert r["replay"]["ok"] and r["replay"]["mismatches"] == [0, 0]
    assert [r["replay"]["writes"] for r in ranks] == [2, 0, 0, 0]


def test_mesh_cost_model_key(ranks):
    """A mesh table's cost model is keyed apart from its stacked copy's."""
    got = same_on_every_rank(ranks, "cost_keys")
    assert got == {"mesh_shape": [2, 2], "stacked_shape": None,
                   "differ": True}


# ---------------------------------------------------------------------------
# the chaos CLI on a mesh


@pytest.mark.parametrize("fail", [False, True], ids=["clean", "self_test"])
def test_chaos_cli_on_a_mesh(tmp_path, fail):
    """``python -m repro_torch.workloads.chaos --placement sharded`` on
    four gloo ranks joined through ``--dist-init file:///...``: the run
    goes on ``default_mesh_for`` meshes, rank 0 alone prints (and, for a
    failing run, writes the artifact in its working directory), exit 0 on
    a clean run and 1 on the digest self-test, on every rank."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               WORLD_SIZE=str(WORLD))
    args = ["--scenario", "chaos_reshard", "--placement", "sharded",
            "--device", "cpu", "--seed", "5", "--scale", "0.3",
            "--dist-init", f"file://{tmp_path / 'store'}"]
    if fail:
        args += ["--self-test-fail", "5", "--no-shrink"]
    procs = []
    for r in range(WORLD):
        cwd = tmp_path / f"rank{r}"
        cwd.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.workloads.chaos", *args],
            env=dict(env, RANK=str(r)), cwd=str(cwd), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == int(fail), (out[-2000:], err[-4000:])
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = outs[0].splitlines()
    assert lines[0].startswith("[chaos] chaos_reshard/sharded/cpu seed=5: "
                               f"ok={not fail} "), lines
    assert not any(o.strip() for o in outs[1:])
    arts = [(tmp_path / f"rank{r}" / "chaos_failure.json").exists()
            for r in range(WORLD)]
    assert arts == [fail, False, False, False]
    if fail:
        art = json.loads((tmp_path / "rank0" / "chaos_failure.json")
                         .read_text())
        assert art["report"]["ok"] is False and art["shrunk_schedule"] is None


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), sys.argv[2]))
