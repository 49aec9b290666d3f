"""The PyTorch port's elastic ``ResizePolicy`` against the JAX package's.

The cases of ``tests/test_policy.py`` (local placement) on a ``repro_torch``
table with the policy (``plain`` plan, on the CPU) beside a
``repro.table_api.Table`` with the same policy (``backend="xla"``): the
drain that merges and shrinks the depth, the hysteresis no-thrash bound,
the frozen retry through a merge window, ``policy_stats`` and seeded random
op streams — with every state array equal to the JAX package's after
every transaction (the trash rows excepted). The policy counters survive a
snapshot, and elasticity resumes after it. On a sharded table the policy
runs per shard: each shard equals a lone per-shard table driven with its
own lanes. The ``cuda`` plan on the card is held against the ``plain``
plan in ``test_torch_cuda_paths.py``; the JAX sharded table's counters
and pressure in ``test_torch_dist.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import table as JT
from repro.core.policy import ResizePolicy as JaxPolicy
from repro.core.reference import SeqExtHash
from repro.table_api import Table as JaxTable
from repro.table_api import TableSpec as JaxSpec
from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.policy import ResizePolicy
from repro_torch.table_api import Table, TableSpec, to_numpy

jax.config.update("jax_platform_name", "cpu")

SCENARIO_POLICY = dict(split_watermark=0.75, merge_watermark=0.375,
                       max_splits=8, max_merges=4)
# the geometry the drain, stats, random-stream and snapshot cases share (one
# set of JAX compilations)
PGEOM = dict(dmax=9, bucket_size=8, pool_size=512, n_lanes=16)


def tables(geom, policy):
    """A port table and a JAX table with the same geometry and policy
    (``policy`` is a dict of ResizePolicy fields, or None)."""
    t = Table.create(TableSpec(**geom, resize_policy=policy and ResizePolicy(
        **policy)), device="cpu")
    jt = JaxTable.create(JaxSpec(**geom, backend="xla",
                                 resize_policy=policy and JaxPolicy(**policy)))
    return t, jt


def assert_same_state(t, jt, where="", skip=()):
    P = t.spec.pool_size
    for f, x in to_numpy(t.state).items():
        if f in skip:
            continue
        y = np.asarray(getattr(jt.state, f))
        if x.ndim and x.shape[0] == P + 1:
            x, y = x[:P], y[:P]
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {f}")


def stats(t):
    return tuple(int(v) for v in t.state.policy_counts)


class Both:
    """Drive the port table and the JAX table in lock step, one
    ``n_lanes``-wide NOP-padded ``apply`` at a time — the transactions the
    facade runs for any batch, with one compiled JAX shape per spec:
    statuses and every state array equal after every transaction."""

    def __init__(self, t, jt, skip=()):
        self.t, self.jt, self.skip = t, jt, skip

    def __call__(self, method, keys, vals=None, *, kinds=None, where=""):
        keys = np.asarray(keys, np.int32)
        m, n = keys.size, self.t.spec.n_lanes
        if kinds is None:
            kinds = np.full(m, {"insert": T.INS, "delete": T.DEL}[method],
                            np.int32)
        vals = np.zeros(m, np.int32) if vals is None else vals
        out = []
        for lo in range(0, m, n):
            k, ky, v = (np.pad(np.asarray(x, np.int32)[lo:lo + n],
                               (0, max(0, lo + n - m)))
                        for x in (kinds, keys, vals))
            self.t, res = self.t.apply(k, ky, v)
            self.jt, jres = self.jt.apply(k, ky, v)
            np.testing.assert_array_equal(res.status.numpy(),
                                          np.asarray(jres.status),
                                          err_msg=where)
            assert_same_state(self.t, self.jt, where or method, self.skip)
            out.append(res.status.numpy()[:m - lo])
        return np.concatenate(out)

    def nop_rounds(self, rounds):
        nop = np.zeros(self.t.spec.n_lanes, np.int32)
        for r in range(rounds):
            self("apply", nop, kinds=nop, where=f"nop round {r}")


@pytest.mark.parametrize("kw, bucket_size", [
    (dict(split_watermark=0.5, merge_watermark=0.5), None),
    (dict(split_watermark=0.2, merge_watermark=0.6), None),
    (dict(max_merges=-1), None),
    (dict(split_watermark=0.4, merge_watermark=0.1), 2),
    (dict(min_depth=9), 8),
])
def test_policy_validation(kw, bucket_size):
    """The JAX package asserts; the port raises ValueError for the same
    settings — in the policy, or at spec construction where the bound
    depends on the bucket size or dmax."""
    def build(policy_cls, spec_cls):
        pol = policy_cls(**kw)
        if bucket_size is not None:
            spec_cls(bucket_size=bucket_size, dmax=8, resize_policy=pol)

    with pytest.raises(AssertionError):
        build(JaxPolicy, JaxSpec)
    with pytest.raises(ValueError):
        build(ResizePolicy, TableSpec)
    with pytest.raises(TypeError):
        TableSpec(resize_policy=JaxPolicy())


def test_drain_merges_and_depth_shrinks():
    both = Both(*tables(PGEOM, SCENARIO_POLICY))
    ref = SeqExtHash(9, 8)
    keys = np.random.default_rng(42).choice(
        np.arange(1, 1 << 20), size=260, replace=False).astype(np.int32)
    assert (both("insert", keys, keys * 5) == 1).all()
    for k in keys:
        ref.insert(int(k), int(k) * 5)
    splits0, merges0 = stats(both.t)
    assert splits0 > 0 and merges0 == 0
    depth_hi = int(both.t.depth())
    both("delete", keys[:247])
    for k in keys[:247]:
        ref.delete(int(k))
    both.nop_rounds(30)
    splits1, merges1 = stats(both.t)
    assert merges1 > 0, "drain must drive the merge path"
    assert int(both.t.depth()) < depth_hi
    assert not bool(both.t.state.error)
    check_invariants(both.t.config, both.t.state)
    assert to_dict(both.t.config, both.t.state) == ref.as_dict()


def _key(prefix: int, depth: int, j: int) -> int:
    """An i32 key whose identity-hash top ``depth`` bits equal ``prefix``."""
    u = ((prefix << (32 - depth)) | (j + 1)) & 0xFFFFFFFF
    return int(np.int32(np.uint32(u)))


def test_hysteresis_no_thrash_at_watermark_boundary():
    """B=8: split at 6 items, merge at a combined 3. Oscillation inside the
    band does nothing; one crossing of either watermark does exactly one
    action, and oscillating at the boundary after it stays quiet."""
    pol = dict(split_watermark=0.75, merge_watermark=0.375, max_splits=4,
               max_merges=4, min_depth=2)
    geom = dict(dmax=6, bucket_size=8, pool_size=64, n_lanes=8,
                hash_name="identity", initial_depth=2)
    both = Both(*tables(geom, pol))
    region = ([_key(0b010, 3, j) for j in range(3)]
              + [_key(0b011, 3, j) for j in range(2)])
    assert (both("insert", np.asarray(region, np.int32)) == 1).all()
    assert stats(both.t) == (0, 0)
    probe = np.asarray([region[0]], np.int32)
    for _ in range(25):
        both("delete", probe)
        both("insert", probe)
    assert stats(both.t) == (0, 0) and int(both.t.depth()) == 2
    sixth = np.asarray([_key(0b011, 3, 7)], np.int32)
    both("insert", sixth)
    assert stats(both.t) == (1, 0) and int(both.t.depth()) == 3
    for _ in range(20):
        both("delete", sixth)
        both("insert", sixth)
    assert stats(both.t) == (1, 0) and int(both.t.depth()) == 3
    assert (both("delete", np.asarray(region[:3], np.int32)) == 1).all()
    both.nop_rounds(5)
    assert stats(both.t) == (1, 1) and int(both.t.depth()) == 2
    both.nop_rounds(10)
    assert stats(both.t) == (1, 1)
    check_invariants(both.t.config, both.t.state)


@pytest.mark.parametrize("with_policy", [False, True])
def test_frozen_retry_parity_through_merge_window(with_policy):
    pol = (dict(split_watermark=0.75, merge_watermark=0.3, max_splits=2,
                max_merges=1, min_depth=2) if with_policy else None)
    geom = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8,
                hash_name="identity", initial_depth=2)
    both = Both(*tables(geom, pol))
    ref = SeqExtHash(6, 4, initial_depth=2, hash_name="identity")
    k_in0, k_in1, k_out = (_key(0b10, 2, 0), _key(0b11, 2, 0),
                           _key(0b01, 2, 0))
    seed = np.asarray([k_in0, k_in1, k_out], np.int32)
    both("insert", seed, np.asarray([11, 22, 33], np.int32))
    for k, v in zip(seed, (11, 22, 33)):
        ref.insert(int(k), v)
    st, ok = T.freeze_buddies(both.t.config, both.t.state, 1, 1)
    jst, jok = JT.freeze_buddies(both.jt.config, both.jt.state, 1, 1)
    assert bool(ok) and bool(jok)
    both.t, both.jt = both.t._replace(state=st), both.jt._replace(state=jst)

    kinds = np.asarray([T.INS, T.DEL, T.INS], np.int32)
    keys = np.asarray([_key(0b10, 2, 5), k_in1, k_out], np.int32)
    vals = np.asarray([111, 0, 222], np.int32)
    assert both("apply", keys, vals, kinds=kinds).tolist() == [
        T.FROZEN, T.FROZEN, T.FALSE]
    ref.insert(int(k_out), 222)
    found, v = both.t.lookup(np.asarray([k_in0, k_in1, keys[0]], np.int32))
    assert found.tolist() == [True, True, False] and v.tolist()[:2] == [11, 22]

    # the merging thread finishes: unfreeze, then merge (1, 1)
    both.t.state.frozen.zero_()
    both.jt = both.jt._replace(state=both.jt.state._replace(
        frozen=jnp.zeros_like(both.jt.state.frozen)))
    assert_same_state(both.t, both.jt, "unfrozen")
    both.t, ok = both.t.merge(1, 1)
    both.jt, jok = both.jt.merge(1, 1)
    assert bool(ok) and bool(jok) and ref.merge(1, 1)
    assert_same_state(both.t, both.jt, "merged")
    want = [ref.insert(int(keys[0]), 111), ref.delete(int(keys[1]))]
    assert both("apply", keys[:2], vals[:2], kinds=kinds[:2]).tolist() == want
    assert to_dict(both.t.config, both.t.state) == ref.as_dict()
    check_invariants(both.t.config, both.t.state)


def test_policy_stats_match_jax():
    """splits, merges and pressure (to 1e-6) after every transaction of a
    fill, a drain and read-only maintenance traffic; all zeros without a
    policy."""
    both = Both(*tables(PGEOM, SCENARIO_POLICY))
    rng = np.random.default_rng(8)
    keys = rng.choice(np.arange(1, 1 << 20), size=400,
                      replace=False).astype(np.int32)
    nop = np.zeros(16, np.int32)
    batches = ([("insert", keys[i:i + 16], keys[i:i + 16])
                for i in range(0, 400, 16)]
               + [("delete", keys[i:i + 16]) for i in range(0, 368, 16)]
               + [("apply", nop)] * 8)
    pressures = []
    for i, (method, *args) in enumerate(batches):
        both(method, *args, kinds=nop if method == "apply" else None,
             where=f"batch {i}")
        got, want = both.t.policy_stats(), both.jt.policy_stats()
        assert int(got["splits"]) == int(want["splits"])
        assert int(got["merges"]) == int(want["merges"])
        assert got["pressure"].dtype == torch.float32
        assert abs(float(got["pressure"]) - float(want["pressure"])) <= 1e-6
        pressures.append(float(got["pressure"]))
    assert stats(both.t)[0] > 0 and stats(both.t)[1] > 0
    assert max(pressures) > 0
    plain = Table.create(TableSpec(**PGEOM), device="cpu")
    plain, _ = plain.insert(keys, keys)
    assert [float(v) for v in plain.policy_stats().values()] == [0, 0, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_streams_keep_state_parity(seed):
    """Seeded random streams of mixed batches (lengths 1–60 over a small
    universe) through a policy table: statuses and every state array equal
    the JAX package's after every transaction, the invariants hold and the
    content equals the sequential oracle."""
    both = Both(*tables(PGEOM, SCENARIO_POLICY))
    ref = SeqExtHash(9, 8)
    rng = np.random.default_rng(seed)
    for rnd in range(16):
        m = int(rng.integers(1, 61))
        kinds = rng.integers(1, 3, size=m).astype(np.int32)
        kinds[:] = T.INS if rnd < 6 else (T.DEL if rnd < 11 else kinds)
        keys = rng.integers(1, 400, size=m).astype(np.int32)
        vals = rng.integers(0, 999, size=m).astype(np.int32)
        got = both("apply", keys, vals, kinds=kinds, where=f"round {rnd}")
        want = [ref.insert(int(k), int(v)) if c == T.INS
                else ref.delete(int(k)) for c, k, v in zip(kinds, keys, vals)]
        assert got.tolist() == want
        # an OVERFLOW sets the error flag for good (both packages agree on
        # it: the flag is a state array compared above)
        check_invariants(both.t.config, both.t.state,
                         allow_error=bool(both.t.state.error))
        assert to_dict(both.t.config, both.t.state) == ref.as_dict()
    assert min(stats(both.t)) > 0, "both policy passes ran"


def test_policy_counters_survive_snapshot(tmp_path):
    """A policy table saved and restored (policy detached during the load)
    keeps its counters, and a drain after the revive merges again; the JAX
    package restoring the same image agrees."""
    both = Both(*tables(PGEOM, SCENARIO_POLICY))
    keys = np.random.default_rng(4).choice(
        np.arange(1, 1 << 20), size=300, replace=False).astype(np.int32)
    both("insert", keys, keys * 3)
    both("delete", keys[:100])
    before = stats(both.t)
    assert before[0] > 0
    path = both.t.save(str(tmp_path / "t.npz"))
    t = Table.restore(path, both.t.spec, device="cpu")
    jt = JaxTable.restore(path, both.jt.spec)
    assert stats(t) == before == tuple(int(v) for v in jt.state.policy_counts)
    assert t.spec.resize_policy == both.t.spec.resize_policy
    assert t.plan().backend == "plain"
    assert to_dict(t.config, t.state) == to_dict(both.t.config, both.t.state)
    # the JAX restore NOP-pads the image to whole 1,024-op batches (one
    # compiled shape), so its transactions — applied_seq — run ahead
    revived = Both(t, jt, skip=("applied_seq",))
    assert_same_state(t, jt, "restored", revived.skip)
    revived("delete", keys[100:290])
    revived.nop_rounds(20)
    after = stats(revived.t)
    assert after[1] > before[1], "elasticity resumes after the revive"
    check_invariants(revived.t.config, revived.t.state)


def test_policy_runs_per_shard():
    """Fill then drain a 2-shard table with the scenarios' policy: each
    shard's state equals a lone per-shard table (``hash_shift`` 1) driven
    through the same policy with only its own lanes, array for array; both
    shards split and merge, the depth shrinks, ``policy_stats`` sums the
    shards' counters and ``pressure`` is taken over all their live
    buckets."""
    from repro_torch.core import dist as D
    from repro_torch.core.policy import resize_pressure, wrap_apply_fn

    pol = ResizePolicy(**SCENARIO_POLICY)
    spec = TableSpec(**PGEOM, placement="sharded", shard_bits=1,
                     resize_policy=pol)
    lcfg = spec.table_config()
    t = Table.create(spec, device="cpu")
    lones = [T.init_table(lcfg, "cpu") for _ in range(spec.n_shards)]
    apply_fn = wrap_apply_fn(pol, T.apply_batch)
    rng = np.random.default_rng(4)
    live, depth_peak = set(), 0
    for step in range(60):
        if step < 30:
            keys = rng.integers(1, 2**31 - 1, size=16).astype(np.int32)
            kinds = np.ones(16, np.int32)
        else:
            pool = sorted(live) or [1]
            keys = rng.choice(pool, size=16).astype(np.int32)
            kinds = np.full(16, 2, np.int32)
        live = (live | set(keys.tolist()) if step < 30
                else live - set(keys.tolist()))
        t, res = t.apply(kinds, keys, keys)
        dest = D._dest_shard(spec.dist_config(), torch.from_numpy(keys))
        for j in range(spec.n_shards):
            mine = dest == j
            ops = T.OpBatch(
                kind=torch.where(mine, torch.from_numpy(kinds), T.NOP),
                key=torch.from_numpy(keys), value=torch.from_numpy(keys),
                seq=torch.full((16,), step + 1, dtype=torch.int32))
            lones[j], r = apply_fn(lcfg, lones[j], ops)
            np.testing.assert_array_equal(res.status[mine].numpy(),
                                          r.status[mine].numpy())
        depth_peak = max(depth_peak, int(t.depth()))
    got = to_numpy(t.state)
    for j, lone in enumerate(lones):
        for f, x in to_numpy(lone).items():
            np.testing.assert_array_equal(got[f][j], x, err_msg=f"{j}: {f}")
        assert min(lone.policy_counts.tolist()) > 0, j
    check_invariants(t.config, t.state)
    st = t.policy_stats()
    assert [int(st["splits"]), int(st["merges"])] == np.sum(
        [lone.policy_counts.tolist() for lone in lones], axis=0).tolist()
    assert int(t.depth()) < depth_peak
    n_live = [int(lone.live.sum()) for lone in lones]
    n_near = sum(round(float(resize_pressure(lcfg, pol, lone)) * n)
                 for lone, n in zip(lones, n_live))
    want = torch.tensor(n_near, dtype=torch.float32) / sum(n_live)
    assert float(st["pressure"]) == float(want)
