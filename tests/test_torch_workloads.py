"""The PyTorch port's workloads against the JAX package's.

* the copied generators and traces give the same step streams as
  ``repro.workloads`` for every op mix and key distribution;
* the copied oracles give the same statuses and content digests;
* the scenario registry has the JAX package's names, traces, specs and
  policy, for both placements;
* ``phased_drain``, ``mixed_churn`` and ``snapshot_restore`` replay through
  the port (``plain`` plan, on the CPU) at a reduced ``scale`` with no
  mismatch against both oracles, prove elasticity (depth decreases and
  policy merges), and report the same depth trajectory and policy counters
  as the JAX replay (``backend="xla"``) of the same trace, run in a fresh
  subprocess (XLA's CPU compiler has crashed in test workers that had
  compiled many JAX programs before); every local scenario in the
  registry replays through the port;
* every scenario replays through a sharded port table with no mismatch
  against both oracles (aggregate ``dmax + shard_bits`` bits), also when
  the revives move it to another shard count or placement; and a sharded
  replay's depth trajectory and policy counters equal the JAX sharded
  table's, driven one ``n_lanes`` chunk per call over the same trace in a
  subprocess with 8 forced host devices (the JAX package's own sharded
  replay fails at its facade under an explicit-axis mesh).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import reference as JR
from repro.workloads import generators as JG
from repro.workloads import get_scenario as jax_get_scenario
from repro.workloads import replay as jax_replay
from repro.workloads import scenarios as JSC
from repro.workloads import trace as JTR
from repro_torch.core import reference as R
from repro_torch.workloads import SCENARIOS, get_scenario, replay
from repro_torch.workloads import generators as G
from repro_torch.workloads import scenarios as SC
from repro_torch.workloads import trace as TR

jax.config.update("jax_platform_name", "cpu")

CHURNY = ("phased_drain", "mixed_churn", "snapshot_restore")
# the JAX replay compiles one transaction per distinct batch length, which
# sets its time: the comparisons run at a tenth of the registry's steps
SCALE = 0.25
JAX_SCALE = 0.1


def stream(trace_mod, phases, universe, seed):
    trace = trace_mod.Trace(name="t", phases=phases, universe=universe,
                            seed=seed)
    return [(s.phase, s.kinds.tolist(), s.keys.tolist(), s.vals.tolist(),
             s.reads.tolist()) for s in trace_mod.gen_steps(trace)]


@pytest.mark.parametrize("dist", ["uniform", "zipf", "latest"])
@pytest.mark.parametrize("mix", sorted(JG.YCSB_MIXES))
def test_step_streams_match_jax(mix, dist):
    """A fill, then the mix under the distribution, then a drain, over a
    universe small enough that fresh inserts run out: the same steps."""
    def phases(mod):
        return (mod.Phase("fill", 4, "fill", batch=40),
                mod.Phase("mix", 6, mix, dist=dist, theta=0.9, batch=40),
                mod.Phase("drain", 3, "drain", batch=40))

    for seed in (0, 7):
        got = stream(TR, phases(TR), 200, seed)
        want = stream(JTR, phases(JTR), 200, seed)
        assert got == want
    assert G.YCSB_MIXES[mix] == G.OpMix(**dataclasses.asdict(
        JG.YCSB_MIXES[mix]))


def test_phased_trace_matches_jax():
    kw = dict(universe=1 << 12, seed=3, fill_steps=6, stable_steps=4,
              drain_steps=6, refill_steps=3, batch=32, dist="zipf")
    got, want = TR.phased("p", **kw), JTR.phased("p", **kw)
    assert ([dataclasses.astuple(p) for p in got.phases]
            == [dataclasses.astuple(p) for p in want.phases])
    assert stream(TR, got.phases, got.universe, got.seed) == stream(
        JTR, want.phases, want.universe, want.seed)


def test_oracles_and_digests_match_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(-2**31 + 1, 2**31 - 1, size=5000).astype(np.int64)
    vals = rng.integers(-2**31, 2**31 - 1, size=5000).astype(np.int64)
    assert R.content_digest(keys, vals) == JR.content_digest(keys, vals)
    assert R.content_digest([], []) == JR.content_digest([], []) == 0
    assert all(R.pair_digest(int(k), int(v)) == JR.pair_digest(int(k), int(v))
               for k, v in zip(keys[:50], vals[:50]))
    kinds = rng.integers(0, 3, size=3000)
    ks = rng.integers(1, 600, size=3000)
    vs = rng.integers(0, 1000, size=3000)
    mine, theirs = R.StreamingOracle(6, 4), JR.StreamingOracle(6, 4)
    np.testing.assert_array_equal(mine.run_ops(kinds, ks, vs),
                                  theirs.run_ops(kinds, ks, vs))
    assert mine.digest == theirs.digest and mine.size == theirs.size
    seq, jseq = R.SeqExtHash(6, 4), JR.SeqExtHash(6, 4)
    for c, k, v in zip(kinds[:800].tolist(), ks.tolist(), vs.tolist()):
        if c == 1:
            assert seq.insert(k, v) == jseq.insert(k, v)
        elif c == 2:
            assert seq.delete(k) == jseq.delete(k)
    assert seq.as_dict() == jseq.as_dict()
    assert seq.layout() == jseq.layout()


def test_scenario_registry_matches_jax():
    assert SCENARIOS == JSC.SCENARIOS
    assert dataclasses.asdict(SC.POLICY) == dataclasses.asdict(JSC.POLICY)
    assert SC.scenario_matrix() == JSC.scenario_matrix()
    for name, placement in ((n, p) for n in SCENARIOS
                            for p in ("local", "sharded")):
        for policy in (True, False):
            spec, trace = get_scenario(name, placement=placement,
                                       policy=policy, scale=0.5, seed=2)
            jspec, jtrace = jax_get_scenario(name, placement=placement,
                                             policy=policy, scale=0.5,
                                             seed=2)
            assert ((trace.name, trace.universe, trace.seed)
                    == (jtrace.name, jtrace.universe, jtrace.seed))
            assert ([dataclasses.astuple(p) for p in trace.phases]
                    == [dataclasses.astuple(p) for p in jtrace.phases])
            for f in dataclasses.fields(spec):
                a, b = getattr(spec, f.name), getattr(jspec, f.name)
                if f.name == "resize_policy" and a is not None:
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                assert a == b, (name, f.name)
    with pytest.raises(KeyError):
        get_scenario("nope")


def _summary(rep):
    return {"steps": rep["steps"], "mutations": rep["mutations"],
            "reads": rep["reads"], "depth": rep["depth"],
            "policy": rep["policy"],
            "snapshot_restores": rep["snapshot_restores"],
            "phases": [(p["name"], p["steps"], p["ops"])
                       for p in rep["phases"]]}


@pytest.mark.parametrize("name", CHURNY)
def test_churn_replay_matches_jax(name):
    spec, trace = get_scenario(name, scale=JAX_SCALE)
    rep = replay(spec, trace, device="cpu", oracle="both",
                 raise_on_mismatch=False)
    assert rep["ok"], (rep["status_mismatches"], rep["content_mismatches"],
                       rep["mismatch_examples"], rep["error_flag"])
    assert rep["checked"] and rep["oracle"] == "both"
    assert rep["mutations"] > 0 and rep["reads"] > 0
    d = rep["depth"]
    assert d["increases"] > 0 and d["decreases"] > 0, d
    assert rep["policy"]["splits"] > 0 and rep["policy"]["merges"] > 0
    assert rep["snapshot_restores"] == (2 if name == "snapshot_restore"
                                        else 0)
    jrep = _jax_subprocess(["--jax-churn", name])
    assert jrep["ok"]
    assert _plain(_summary(rep)) == jrep["summary"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_every_local_scenario_replays(name):
    spec, trace = get_scenario(name, scale=SCALE, seed=1)
    rep = replay(spec, trace, device="cpu", oracle="streaming")
    assert rep["ok"] and rep["status_mismatches"] == 0
    assert rep["depth"]["increases"] > 0 and rep["policy"]["splits"] > 0
    plain = replay(get_scenario(name, policy=False, scale=SCALE, seed=1)[0],
                   trace, device="cpu", check=False)
    assert plain["policy"] is None and not plain["checked"]
    assert plain["steps"] == rep["steps"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_every_sharded_scenario_replays(name):
    spec, trace = get_scenario(name, placement="sharded", scale=SCALE,
                               seed=1)
    assert spec.placement == "sharded" and spec.n_shards == 2
    rep = replay(spec, trace, device="cpu", oracle="both",
                 raise_on_mismatch=False)
    assert rep["ok"], (rep["status_mismatches"], rep["content_mismatches"],
                       rep["mismatch_examples"], rep["error_flag"])
    assert rep["placement"] == "sharded" and rep["checked"]
    assert rep["depth"]["increases"] > 0 and rep["policy"]["splits"] > 0


@pytest.mark.parametrize("restore", [
    dict(placement="sharded", shard_bits=2, dmax=8),    # 2 -> 4 shards
    dict(placement="local", dmax=10, pool_size=1536),   # sharded -> local
])
def test_sharded_replay_reshards_at_revives(restore):
    """``snapshot_restore``'s two revives move the table to another shard
    count or placement mid-trace; the oracles run on at the aggregate
    addressing, which every target keeps (dmax + shard_bits = 10)."""
    spec, trace = get_scenario("snapshot_restore", placement="sharded",
                               scale=SCALE)
    target = dataclasses.replace(spec, **restore)
    rep = replay(spec, trace, device="cpu", oracle="both",
                 raise_on_mismatch=False, restore_spec=target)
    assert rep["ok"], (rep["status_mismatches"], rep["content_mismatches"],
                       rep["mismatch_examples"])
    assert rep["snapshot_restores"] == 2
    assert rep["policy"]["splits"] > 0 and rep["policy"]["merges"] > 0


def _plain(obj):
    """``obj`` as JSON gives it back: tuples as lists, numpy scalars as
    Python numbers."""
    return json.loads(json.dumps(obj, default=lambda o: o.item()))


def _jax_churn_summary(name, out_path):
    """The JAX replay of churn scenario ``name`` at ``JAX_SCALE``
    (``backend="xla"``, streaming oracle): ``ok`` and ``_summary``."""
    jspec, jtrace = jax_get_scenario(name, scale=JAX_SCALE)
    jrep = jax_replay(jspec, jtrace, oracle="streaming",
                      raise_on_mismatch=False)
    with open(out_path, "w") as f:
        json.dump({"ok": bool(jrep["ok"]),
                   "summary": _plain(_summary(jrep))}, f)
    print("jax side OK")
    return 0


def _jax_subprocess(args, timeout=600):
    """Run this file's JAX half (``--jax-...``) in a fresh process on the
    CPU; returns the JSON it writes."""
    import tempfile
    here = os.path.abspath(__file__)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "..", "src"))
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "jax.json")
        proc = subprocess.run([sys.executable, here, *args, out], env=env,
                              capture_output=True, text=True,
                              timeout=timeout)
        assert proc.returncode == 0, (proc.stdout[-3000:],
                                      proc.stderr[-3000:])
        with open(out) as f:
            return json.load(f)


# the JAX side of the sharded replay comparison (subprocess)
SHARDED = "phased_drain"


def _jax_sharded_depths(out_path):
    """The JAX sharded table over ``SHARDED``'s trace, one ``n_lanes`` chunk
    per ``apply`` call: the depth after every step and the final policy
    counters, as the port's ``replay`` reports them."""
    from jax.sharding import AxisType

    from repro import compat
    from repro.table_api import Table as JaxTable

    jspec, jtrace = jax_get_scenario(SHARDED, placement="sharded",
                                     scale=JAX_SCALE)
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    n = jspec.n_lanes
    with compat.set_mesh(mesh):
        t = JaxTable.create(jspec, mesh)
        depths = [int(t.depth())]
        for step in JTR.gen_steps(jtrace):
            for lo in range(0, step.kinds.shape[0], n):
                t, _ = t.apply(step.kinds[lo:lo + n], step.keys[lo:lo + n],
                               step.vals[lo:lo + n])
            jax.block_until_ready(t.state)
            depths.append(int(t.depth()))
        stats = t.policy_stats()
        np.savez(out_path, depths=np.asarray(depths),
                 policy=np.asarray([int(stats["splits"]),
                                    int(stats["merges"])]),
                 error=np.asarray(t.state.error))
    print("jax side OK")
    return 0


def test_sharded_replay_matches_jax_chunked(tmp_path):
    path = str(tmp_path / "jax.npz")
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(here), "..", "src")
    proc = subprocess.run([sys.executable, here, "--jax-sharded", path],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    spec, trace = get_scenario(SHARDED, placement="sharded",
                               scale=JAX_SCALE)
    rep = replay(spec, trace, device="cpu", oracle="both",
                 raise_on_mismatch=False)
    assert rep["ok"]
    with np.load(path) as z:
        assert rep["depth"]["trajectory"] == z["depths"].tolist()
        assert [rep["policy"]["splits"], rep["policy"]["merges"]] == \
            z["policy"].tolist()
        assert not z["error"].any()
    d = rep["depth"]
    assert d["increases"] > 0 and d["decreases"] > 0, d


if __name__ == "__main__":
    if sys.argv[1] == "--jax-churn":
        sys.exit(_jax_churn_summary(sys.argv[2], sys.argv[3]))
    assert sys.argv[1] == "--jax-sharded", sys.argv
    sys.exit(_jax_sharded_depths(sys.argv[2]))
