"""The PyTorch port's chaos harness against the JAX package's.

* ``gen_schedule`` and ``chaos_setup`` give the JAX package's schedules,
  specs and traces;
* the shrinker finds the same minimal failing schedules;
* one port run of ``chaos_churn`` (CPU) fires all six event kinds under
  the dual oracle with no mismatch, and the digest self-test fails a run;
* the CLI writes the failing-seed artifact and exits 0 on a clean run;
* a port run and a JAX run (``backend="xla"``) of the same schedule, all
  kinds but ``backend_swap`` (the JAX package's ``interpret`` candidate
  reaches a Pallas call its JAX version no longer has), give equal
  statuses and reads step by step, equal digests and item counts after
  every event and at the end, and the same depth trajectory and policy
  counters;
* a sharded run (``chaos_reshard``, seed 5, scale 0.3, the JAX package's
  ``test_chaos_sharded_cross_placement``) crosses placements and shard
  counts (2 / 4 / 8 shards and local) and equals the JAX run's, driven in
  a subprocess with 8 forced host devices on meshes with automatic axes
  (``ROADMAP.md`` §3), step for step and event for event, every event's
  ``to`` and ``invariant_shards`` included;
* re-shards and a handover forced onto 4- and 8-shard targets and back to
  local hold every digest and the invariants per shard against the
  oracles.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.table_api import Table as JaxTable
from repro.workloads import chaos as JC
from repro_torch.table_api import Table
from repro_torch.workloads import chaos as C
from test_torch_dist import session_path
from test_torch_mesh_serving import recorded_run as _recorded_run

jax.config.update("jax_platform_name", "cpu")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
HERE = os.path.abspath(__file__)


@pytest.mark.parametrize("seed", [0, 11, 12])
@pytest.mark.parametrize("kinds", [C.EVENT_KINDS, ("kill_revive", "torn_save"),
                                   ("reshard", "policy_flap", "handover")])
def test_schedules_match_jax(kinds, seed):
    for total, n in ((500, 9), (100, 2), (40, 0)):
        cfg = C.ChaosConfig(n_events=n, kinds=kinds, seed=seed)
        jcfg = JC.ChaosConfig(n_events=n, kinds=kinds, seed=seed)
        ours = C.gen_schedule(total, cfg)
        assert ([dataclasses.astuple(e) for e in ours]
                == [dataclasses.astuple(e) for e in JC.gen_schedule(total,
                                                                    jcfg)])
        assert len(ours) == n and all(1 <= e.step < total for e in ours)
        if n >= len(kinds):
            assert {e.kind for e in ours} == set(kinds)
    spec, trace, sched = C.chaos_setup("chaos_churn", seed=seed, kinds=kinds,
                                       scale=0.4)
    jspec, jtrace, jsched = JC.chaos_setup("chaos_churn", seed=seed,
                                           kinds=kinds, scale=0.4)
    for f in ("dmax", "bucket_size", "pool_size", "n_lanes", "hash_name",
              "initial_depth", "placement"):
        assert getattr(spec, f) == getattr(jspec, f), f
    assert (dataclasses.asdict(spec.resize_policy)
            == dataclasses.asdict(jspec.resize_policy))
    assert ((trace.name, trace.universe, trace.seed, trace.total_steps)
            == (jtrace.name, jtrace.universe, jtrace.seed, jtrace.total_steps))
    assert ([dataclasses.astuple(e) for e in sched]
            == [dataclasses.astuple(e) for e in jsched])
    with pytest.raises(ValueError):
        C.gen_schedule(10, C.ChaosConfig(kinds=("meteor",)))


def test_long_setup_matches_jax():
    """The ≥100k-op sizing (the chip run's ``ops=110_000``): the same
    stretched spec, universe and schedule as the JAX package's."""
    spec, trace, sched = C.chaos_setup("chaos_churn", seed=1, ops=110_000)
    jspec, jtrace, jsched = JC.chaos_setup("chaos_churn", seed=1, ops=110_000)
    assert (spec.dmax, spec.pool_size, spec.n_lanes) == (
        jspec.dmax, jspec.pool_size, jspec.n_lanes) == (19, 27_528, 16)
    assert trace.universe == jtrace.universe
    assert sum(p.steps * p.batch for p in trace.phases) >= 100_000
    assert ([dataclasses.astuple(e) for e in sched]
            == [dataclasses.astuple(e) for e in jsched])


def test_shrink_schedule_minimal():
    """The predicates of the JAX package's shrinker test."""
    evs = tuple(C.ChaosEvent(i, "kill_revive", i) for i in range(10))
    bad = evs[6]
    assert C.shrink_schedule(lambda s: bad in s, evs) == (bad,)
    pair = {evs[2], evs[8]}
    assert set(C.shrink_schedule(lambda s: pair <= set(s), evs)) == pair
    assert C.shrink_schedule(lambda s: True, evs) == ()
    with pytest.raises(ValueError):
        C.shrink_schedule(lambda s: False, evs)


def test_chaos_all_event_kinds():
    """One port run firing every event kind, dual-oracle checked: per-op
    parity, per-event invariants, and digest-exact content parity after
    each injection; ``backend_swap`` cycles the port's backends."""
    spec, trace, schedule = C.chaos_setup("chaos_churn", seed=3, scale=0.4)
    assert {e.kind for e in schedule} == set(C.EVENT_KINDS)
    rep = C.chaos_replay(spec, trace, schedule, device="cpu", oracle="both")
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["checked"] and rep["oracle"] == "both"
    assert rep["events_skipped"] == 0
    assert set(rep["event_counts"]) == set(C.EVENT_KINDS)
    assert all(r["digest_ok"] for r in rep["events"])
    assert all(r["invariant_shards"] == 1 for r in rep["events"])
    assert {r["backend"] for r in rep["events"] if "backend" in r} <= {
        "plain", "cuda", "auto"}
    handover = next(r for r in rep["events"] if r["kind"] == "handover")
    assert handover["router_events"] == ["handover_begin", "handover_end"]
    assert rep["policy"]["splits"] > 0
    assert rep["depth"]["max"] > rep["depth"]["start"]


def test_digest_check_catches_corruption():
    """The harness can fail: a corrupted oracle digest trips the content
    check (the self-test knob the CLI's --self-test-fail uses)."""
    spec, trace, schedule = C.chaos_setup(
        "chaos_churn", seed=0, scale=0.2, kinds=("kill_revive",), n_events=1)
    rep = C.chaos_replay(spec, trace, schedule, device="cpu",
                         raise_on_mismatch=False, _inject_digest_step=2)
    assert not rep["ok"]
    assert rep["content_mismatches"] > 0 and rep["mismatch_examples"]
    with pytest.raises(C.ReplayMismatch):
        C.chaos_replay(spec, trace, schedule, device="cpu",
                       _inject_digest_step=2)


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.workloads.chaos",
         "--scenario", "chaos_churn", "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=str(tmp_path))


@pytest.mark.subprocess
def test_cli_failing_seed_artifact(tmp_path):
    art = tmp_path / "fail.json"
    proc = _cli(tmp_path, "--seed", "0", "--scale", "0.25", "--events", "2",
                "--self-test-fail", "5", "--artifact", str(art))
    assert proc.returncode == 1, (proc.stdout[-3000:], proc.stderr[-3000:])
    a = json.loads(art.read_text())
    # the injected digest fault is not event-induced: shrinks to empty
    assert a["shrunk_schedule"] == []
    assert a["report"]["ok"] is False
    assert a["repro"].startswith("python -m repro_torch.workloads.chaos ")
    assert "--seed 0" in a["repro"] and "--device cpu" in a["repro"]
    assert "wrote failing-seed artifact" in proc.stdout


@pytest.mark.subprocess
def test_cli_clean_run(tmp_path):
    proc = _cli(tmp_path, "--seed", "3", "--scale", "0.3", "--events", "3",
                "--kinds", "kill_revive,policy_flap,torn_save")
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "ok=True" in proc.stdout
    assert not (tmp_path / "chaos_failure.json").exists()


def test_chaos_run_matches_jax(monkeypatch):
    kinds = ("kill_revive", "reshard", "policy_flap", "handover",
             "torn_save")
    # JAX compiles set this test's time, so the trace is short: 14 steps
    spec, trace, schedule = C.chaos_setup("chaos_churn", seed=5, scale=0.15,
                                          kinds=kinds)
    jspec, jtrace, jsched = JC.chaos_setup("chaos_churn", seed=5, scale=0.15,
                                           kinds=kinds)
    assert {e.kind for e in schedule} == set(kinds)
    rep, log = _recorded_run(C, Table, monkeypatch, spec, trace, schedule,
                             device="cpu")
    jrep, jlog = _recorded_run(JC, JaxTable, monkeypatch,
                               dataclasses.replace(jspec, backend="xla"),
                               jtrace, jsched)
    assert rep["ok"] and jrep["ok"], (rep["mismatch_examples"],
                                      jrep["mismatch_examples"])
    assert len(log["apply"]) == len(jlog["apply"]) == rep["steps"]
    for a, b in zip(log["apply"], jlog["apply"]):
        np.testing.assert_array_equal(a, b)
    assert len(log["lookup"]) == len(jlog["lookup"]) > 0
    for (f, v), (jf, jv) in zip(log["lookup"], jlog["lookup"]):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(v, jv)
    # the torn save's two image digests, each event's check and the end
    assert log["digest"] == jlog["digest"]
    assert len(log["digest"]) >= len(schedule) + 1
    fields = ("step", "kind", "arg", "skipped", "n_items", "digest_ok", "to",
              "policy", "image_intact")
    assert ([{k: r.get(k) for k in fields} for r in rep["events"]]
            == [{k: r.get(k) for k in fields} for r in jrep["events"]])
    for k in ("steps", "mutations", "reads", "event_counts", "error_flag"):
        assert rep[k] == jrep[k], k
    # restores pad differently in the two packages (ROADMAP §3), yet the
    # depth trajectory and the policy counters come out equal
    assert rep["depth"] == jrep["depth"]
    assert rep["depth"]["decreases"] > 0
    assert rep["policy"] == jrep["policy"]


# --- the sharded run against the JAX package's (subprocess) ------------------

def _sharded_setup(mod):
    return mod.chaos_setup("chaos_reshard", placement="sharded", seed=5,
                           scale=0.3)


def _jax_sharded_main(out_path):
    from jax.sharding import AxisType

    def mesh_for(n):
        # the JAX package's default_mesh_for over 8 devices, automatic axes
        return jax.make_mesh((8 // n, n), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    spec, trace, schedule = _sharded_setup(JC)
    rep, log = _recorded_run(
        JC, JaxTable, pytest.MonkeyPatch(),
        dataclasses.replace(spec, backend="xla"), trace, schedule,
        mesh=mesh_for(spec.n_shards), mesh_for=mesh_for,
        raise_on_mismatch=False)
    # the JAX package's own factory's shapes over the 8 devices
    shapes = {}
    for n in range(1, 17):
        for lanes in range(1, 17):
            m = JC.default_mesh_for(n, lanes)
            shapes[f"{n},{lanes}"] = (None if m is None
                                      else list(m.devices.shape))
    out = {"rep": rep,
           "apply": [a.tolist() for a in log["apply"]],
           "lookup": [(f.tolist(), v.tolist()) for f, v in log["lookup"]],
           "digest": log["digest"],
           "mesh_shapes": shapes}
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("jax side OK")
    return 0


def _make_jax_sharded(path, overlap=None):
    """The JAX subprocess's run into ``path``; ``overlap()`` runs while the
    subprocess does."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    tmp = path + ".part"
    proc = subprocess.Popen([sys.executable, HERE, "--jax-sharded", tmp],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        if overlap is not None:
            overlap()
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out[-3000:], err[-3000:])
    os.replace(tmp, path)


def shared_jax_chaos(tmp_path_factory, overlap=None):
    """The JAX sharded chaos run on 8 forced host devices, made once per
    test session (``tests/test_torch_mesh_serving.py`` reads the same
    file). Where this call makes it, ``overlap()`` runs alongside."""
    with open(session_path(tmp_path_factory, "jax_chaos.json",
                           lambda p: _make_jax_sharded(p, overlap))) as f:
        return json.load(f)


def test_sharded_chaos_matches_jax(monkeypatch, tmp_path_factory):
    spec, trace, schedule = _sharded_setup(C)
    port = []

    def port_run():
        port.append(_recorded_run(C, Table, monkeypatch, spec, trace,
                                  schedule, device="cpu",
                                  shard_counts=(2, 4, 8),
                                  raise_on_mismatch=False))

    # the port's run overlaps the JAX subprocess's where this test makes it
    jax_run = shared_jax_chaos(tmp_path_factory, overlap=port_run)
    if not port:
        port_run()
    rep, log = port[0]
    jrep = jax_run["rep"]
    assert rep["ok"] and jrep["ok"], (rep["mismatch_examples"],
                                      jrep["mismatch_examples"])
    assert [a.tolist() for a in log["apply"]] == jax_run["apply"]
    assert len(log["apply"]) == rep["steps"]
    assert ([[f.tolist(), v.tolist()] for f, v in log["lookup"]]
            == jax_run["lookup"])
    assert log["digest"] == jax_run["digest"]
    fields = ("step", "kind", "arg", "skipped", "n_items", "digest_ok", "to",
              "policy", "image_intact", "invariant_shards")
    assert ([{k: r.get(k) for k in fields} for r in rep["events"]]
            == [{k: r.get(k) for k in fields} for r in jrep["events"]])
    for k in ("steps", "mutations", "reads", "event_counts", "error_flag",
              "events_skipped", "placement", "depth", "policy"):
        assert rep[k] == jrep[k], k
    moves = [r for r in rep["events"] if "to" in r]
    placements = {r["to"]["placement"] for r in moves}
    assert placements == {"local", "sharded"}, moves
    assert {r["invariant_shards"] for r in rep["events"]} >= {1, 2}
    assert rep["events_skipped"] == 0


def test_chaos_moves_to_4_and_8_shards():
    """Re-shards and a handover forced onto 4- and 8-shard targets (and
    back to local) through ``_respec_candidates``' ``shard_counts``: every
    event's content digest equals the streaming oracle's, the invariants
    hold on every shard of the target, and every op's status and read
    equals both oracles'."""
    spec, trace, _ = C.chaos_setup("chaos_reshard", placement="sharded",
                                   seed=5, scale=0.3)
    counts = (4, 8)
    cands = C._respec_candidates(spec, shard_counts=counts)
    assert all(m is None for _, m in cands)        # stacked
    shards = [c.n_shards if c.placement == "sharded" else 1
              for c, _ in cands]
    assert shards == [1, 1, 4, 4, 8, 8]
    n = trace.total_steps
    # (kind, candidate index): 4 shards, 8 shards by handover, local,
    # 8 shards, 4 shards with the larger pool
    moves = [("reshard", 2), ("handover", 4), ("reshard", 0),
             ("reshard", 5), ("reshard", 3)]
    schedule = tuple(C.ChaosEvent(n * (i + 1) // (len(moves) + 1), kind, arg)
                     for i, (kind, arg) in enumerate(moves))
    rep = C.chaos_replay(spec, trace, schedule, device="cpu",
                         shard_counts=counts, oracle="both")
    assert rep["ok"], rep["mismatch_examples"]
    assert rep["events_skipped"] == 0 and not rep["error_flag"]
    events = rep["events"]
    assert [r["kind"] for r in events] == [k for k, _ in moves]
    assert [r["invariant_shards"] for r in events] == [4, 8, 1, 8, 4]
    assert [r["to"]["shard_bits"] if r["to"]["placement"] == "sharded"
            else "local" for r in events] == [2, 3, "local", 3, 2]
    assert all(r["digest_ok"] and not r["skipped"] for r in events)
    assert rep["placement"] == "sharded"


def test_respec_candidates_match_jax():
    """``_respec_candidates`` with shard counts 2 / 4 / 8 is the JAX list
    (its 8-device mesh factory) element for element; so is it with a mesh
    factory, meshes included; without either a sharded table keeps its
    shard count and mesh, as JAX does with no factory."""
    keys = ("placement", "shard_bits", "dmax", "pool_size")
    for placement in ("local", "sharded"):
        spec, _, _ = C.chaos_setup("chaos_reshard", placement=placement,
                                   seed=5, scale=0.3)
        jspec, _, _ = JC.chaos_setup("chaos_reshard", placement=placement,
                                     seed=5, scale=0.3)
        for counts, mesh_for in (((2, 4, 8), lambda n: f"mesh{n}"),
                                 (None, None)):
            ours = [tuple(getattr(c, k) for k in keys)
                    for c, _ in C._respec_candidates(spec,
                                                     shard_counts=counts)]
            want = [tuple(getattr(c, k) for k in keys)
                    for c, _ in JC._respec_candidates(jspec, None, mesh_for)]
            assert ours == want, (placement, counts)
            pairs = [(tuple(getattr(c, k) for k in keys), m)
                     for c, m in C._respec_candidates(spec, "m0", mesh_for)]
            jpairs = [(tuple(getattr(c, k) for k in keys), m)
                      for c, m in JC._respec_candidates(jspec, "m0",
                                                        mesh_for)]
            assert pairs == jpairs, (placement, counts)
            assert len(ours) == (8 if counts else
                                 2 + 2 * (placement == "sharded"))
    with pytest.raises(ValueError):
        C._respec_candidates(spec, shard_counts=(3,))


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-sharded", sys.argv
    sys.exit(_jax_sharded_main(sys.argv[2]))
