"""The PyTorch port's workloads against the JAX package's.

* the copied generators and traces give the same step streams as
  ``repro.workloads`` for every op mix and key distribution;
* the copied oracles give the same statuses and content digests;
* the scenario registry has the JAX package's names, traces, specs and
  policy, and its sharded entries raise;
* ``phased_drain``, ``mixed_churn`` and ``snapshot_restore`` replay through
  the port (``plain`` plan, on the CPU) at a reduced ``scale`` with no
  mismatch against both oracles, prove elasticity (depth decreases and
  policy merges), and report the same depth trajectory and policy counters
  as the JAX replay (``backend="xla"``) of the same trace; every local
  scenario in the registry replays through the port.
"""
import dataclasses

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
    for name in SCENARIOS:
        for policy in (True, False):
            spec, trace = get_scenario(name, policy=policy, scale=0.5,
                                       seed=2)
            jspec, jtrace = jax_get_scenario(name, policy=policy, scale=0.5,
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
        with pytest.raises(NotImplementedError):
            get_scenario(name, placement="sharded")
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
    jspec, jtrace = jax_get_scenario(name, scale=JAX_SCALE)
    jrep = jax_replay(jspec, jtrace, oracle="streaming",
                      raise_on_mismatch=False)
    assert jrep["ok"]
    assert _summary(rep) == _summary(jrep)


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
