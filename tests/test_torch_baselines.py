"""The port's comparison baselines against the JAX package and a dict.

``repro_torch.core.baselines`` (LF-Split, LF-Freeze-M, Lock) runs here on
the CPU; the same seeded numpy streams go through the JAX package's
``jit`` functions (``repro.core.baselines``). Every value is an integer,
so every comparison is exact:

* LF-Freeze and Lock equal the JAX package in statuses, lookups and every
  state array, at the JAX tests' sizes and at depth 11 with 512 lanes;
* LF-Split equals the JAX package in statuses and lookups where the JAX
  package is right (its own test streams), equals a dict at 16,384 keys,
  and keeps one sorted list with each bucket's items after its sentinel.
  Its state differs by design (the split-order key; see the module);
* the JAX LF-Split's faults are pinned beside the port's right answer:
  adjacent nodes updated in one batch, and keys lost past ``max_walk``;
* no lookup matches ``EMPTY_KEY``.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro_torch.core import baselines as TB

jax.config.update("jax_platform_name", "cpu")

EMPTY = -2**31


def distinct_keys(rng, m):
    """``m`` distinct int32 keys in [1, 2**31 - 1), seeded order."""
    k = np.unique(rng.integers(1, 2**31 - 1, size=m + m // 8 + 64))
    return rng.permutation(k)[:m].astype(np.int32)


@lru_cache(maxsize=None)
def jax_fns(cfg):
    if isinstance(cfg, JB.SplitConfig):
        return {"update": jax.jit(partial(JB.split_update, cfg)),
                "lookup": jax.jit(partial(JB.split_lookup, cfg))}
    if isinstance(cfg, JB.FreezeConfig):
        return {"update": jax.jit(partial(JB.freeze_update, cfg)),
                "lookup": jax.jit(partial(JB.freeze_lookup, cfg))}
    return {"step": jax.jit(partial(JB.lock_step, cfg))}


def port_cfg(cfg):
    """The port's config with the JAX config's fields."""
    cls = getattr(TB, type(cfg).__name__)
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def t(x):
    return torch.tensor(np.asarray(x))


def assert_same_state(port, ref, where):
    for f in type(ref)._fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{where}: {f}")


def dict_status(model, kinds, keys, vals):
    """Lane-order statuses of a batch against ``model`` (updated)."""
    out = []
    for c, k, v in zip(kinds.tolist(), keys.tolist(), vals.tolist()):
        if c == 1:
            out.append(0 if k in model else 1)
            model[k] = v
        elif c == 2:
            out.append(1 if k in model else 0)
            model.pop(k, None)
        else:
            out.append(1 if k in model else 0)
    return np.asarray(out)


def mixed_stream(rng, universe, n, steps, fill_steps, kind_hi):
    """Batches of ``n`` distinct keys of ``universe``: inserts for
    ``fill_steps`` steps, then kinds drawn from [1, kind_hi)."""
    for s in range(steps):
        keys = rng.choice(universe, size=n, replace=False).astype(np.int32)
        kinds = (np.ones(n, np.int32) if s < fill_steps
                 else rng.integers(1, kind_hi, size=n).astype(np.int32))
        yield kinds, keys, rng.integers(0, 2**31 - 1, size=n).astype(np.int32)


# ---------------------------------------------------------------------------
# (a) LF-Freeze and Lock: lane- and array-exact against the JAX package

SIZES = {
    # the JAX tests' sizes (tests/test_baselines.py:75-107)
    "jax_test": dict(depth=4, n=8, steps=12, fill=0, universe=199,
                     freeze=dict(bucket_size=16, pool_size=512),
                     lock=dict(bucket_size=32)),
    # 512 lanes over a 32,768-key universe: LF-Freeze reports -3
    "depth11": dict(depth=11, n=512, steps=40, fill=16, universe=32768,
                    freeze=dict(bucket_size=8, pool_size=2**14 + 2**11),
                    lock=dict(bucket_size=64)),
}


def universe_of(rng, size):
    if size["universe"] < 1000:
        return np.arange(1, size["universe"] + 1, dtype=np.int32)
    return distinct_keys(rng, size["universe"])


@pytest.mark.parametrize("size", list(SIZES))
def test_freeze_matches_jax(size):
    sz = SIZES[size]
    jcfg = JB.FreezeConfig(depth=sz["depth"], n_lanes=sz["n"], **sz["freeze"])
    tcfg, fns = port_cfg(jcfg), jax_fns(jcfg)
    rng = np.random.default_rng(1)
    universe = universe_of(rng, sz)
    js, ts = JB.freeze_init(jcfg), TB.freeze_init(tcfg, "cpu")
    blocked = 0
    for step, (kinds, keys, vals) in enumerate(mixed_stream(
            rng, universe, sz["n"], sz["steps"], sz["fill"], 3)):
        js, jst = fns["update"](js, *(jnp.asarray(x)
                                      for x in (kinds, keys, vals)))
        ts, tst = TB.freeze_update(tcfg, ts, t(kinds), t(keys), t(vals))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"step {step}")
        assert_same_state(ts, js, f"step {step}")
        for x, y in zip(TB.freeze_lookup(tcfg, ts, t(universe)),
                        fns["lookup"](js, jnp.asarray(universe))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"step {step} lookup")
        blocked += int((tst == -3).sum())
    assert not bool(ts.error)
    assert (blocked > 0) == (size == "depth11")


@pytest.mark.parametrize("size", list(SIZES))
def test_lock_matches_jax(size):
    sz = SIZES[size]
    jcfg = JB.LockConfig(depth=sz["depth"], n_lanes=sz["n"], **sz["lock"])
    tcfg, step_fn = port_cfg(jcfg), jax_fns(jcfg)["step"]
    rng = np.random.default_rng(2)
    universe = universe_of(rng, sz)
    js, ts = JB.lock_init(jcfg), TB.lock_init(tcfg, "cpu")
    model, hits = {}, 0
    for step, (kinds, keys, vals) in enumerate(mixed_stream(
            rng, universe, sz["n"], sz["steps"], sz["fill"], 4)):
        js, jst, jv = step_fn(js, *(jnp.asarray(x)
                                    for x in (kinds, keys, vals)))
        ts, tst, tv = TB.lock_step(tcfg, ts, t(kinds), t(keys), t(vals))
        want = [model.get(k, -1) if c == 3 else -1
                for c, k in zip(kinds.tolist(), keys.tolist())]
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(tst.numpy(),
                                      dict_status(model, kinds, keys, vals))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tv.numpy(), want)
        assert_same_state(ts, js, f"step {step}")
        hits += sum(w >= 0 for w in want)
    assert hits > 0 and not bool(ts.error)


# ---------------------------------------------------------------------------
# (b, c) LF-Split: the JAX package's answers where it is right; a dict


def drive_split(jcfg, steps, seed, keyrange=200):
    """The JAX test's ``drive`` stream through both packages: statuses
    and lookups over the key range equal each other and the dict."""
    tcfg, fns = port_cfg(jcfg), jax_fns(jcfg)
    js, ts = JB.split_init(jcfg), TB.split_init(tcfg, "cpu")
    rng = np.random.default_rng(seed)
    model, n = {}, jcfg.n_lanes
    qs = np.arange(1, keyrange, dtype=np.int32)
    for step in range(steps):
        keys = rng.choice(np.arange(1, keyrange), size=n,
                          replace=False).astype(np.int32)
        kinds = rng.integers(1, 3, size=n).astype(np.int32)
        vals = rng.integers(0, 1000, size=n).astype(np.int32)
        js, jst = fns["update"](js, *(jnp.asarray(x)
                                      for x in (kinds, keys, vals)))
        ts, tst = TB.split_update(tcfg, ts, t(kinds), t(keys), t(vals))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(tst.numpy(),
                                      dict_status(model, kinds, keys, vals))
        found, got = TB.split_lookup(tcfg, ts, t(qs))
        for x, y in zip((found, got), fns["lookup"](js, jnp.asarray(qs))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(
            found.numpy(), [int(k) in model for k in qs])
        np.testing.assert_array_equal(
            got.numpy(), [model.get(int(k), -1) for k in qs])
    assert not bool(ts.error) and not bool(js.error)
    return tcfg, ts, model


def check_split_list(cfg, st, n_items):
    """One sorted list from bucket 0's sentinel to the tail, holding every
    sentinel and ``n_items`` items, each item after its bucket's sentinel
    and before the next one."""
    so, nxt = st.sokey.numpy(), st.nxt.numpy()
    key = st.key.numpy()
    shift = 33 - cfg.depth
    node, last, items, bucket = int(st.buckets[0]), -1, 0, -1
    while node != cfg.max_nodes:
        assert so[node] > last, node
        if so[node] % 2 == 0:
            assert key[node] == EMPTY and so[node] >> shift == bucket + 1
            bucket += 1
        else:
            assert so[node] >> shift == bucket
            items += 1
        last, node = so[node], int(nxt[node])
    assert bucket == cfg.nbuckets - 1 and items == n_items


def test_split_matches_jax_on_jax_stream():
    jcfg = JB.SplitConfig(depth=4, max_nodes=1024, n_lanes=8, max_walk=256)
    tcfg, ts, model = drive_split(jcfg, steps=12, seed=0)
    check_split_list(tcfg, ts, len(model))


def test_split_exact_at_16k_keys():
    """16,384 keys at depth 12 (512 lanes, ``max_walk`` 128, the
    benchmark's), then 60 mixed steps: every status and every lookup of
    the universe against a dict; one sorted list at the end."""
    nkeys, n, depth = 16384, 512, 12
    cfg = TB.SplitConfig(depth=depth, max_nodes=2 * nkeys + (1 << depth) + 64,
                         n_lanes=n, max_walk=128)
    rng = np.random.default_rng(3)
    universe = distinct_keys(rng, 2 * nkeys)
    st, model = TB.split_init(cfg, "cpu"), {}
    ones = np.ones(n, np.int32)
    for keys in np.split(universe[:nkeys], nkeys // n):
        vals = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
        st, status = TB.split_update(cfg, st, t(ones), t(keys), t(vals))
        np.testing.assert_array_equal(status.numpy(),
                                      dict_status(model, ones, keys, vals))
    assert len(model) == nkeys
    for step, (kinds, keys, vals) in enumerate(
            mixed_stream(rng, universe, n, 60, 0, 3)):
        st, status = TB.split_update(cfg, st, t(kinds), t(keys), t(vals))
        np.testing.assert_array_equal(status.numpy(),
                                      dict_status(model, kinds, keys, vals),
                                      err_msg=f"step {step}")
        found, got = TB.split_lookup(cfg, st, t(universe))
        np.testing.assert_array_equal(
            found.numpy(), [k in model for k in universe.tolist()])
        np.testing.assert_array_equal(
            got.numpy(), [model.get(k, -1) for k in universe.tolist()])
    assert not bool(st.error)
    check_split_list(cfg, st, len(model))


def test_split_winners_follow_the_rule():
    """The round's winner rule, lane by lane, on random claims with heavy
    sharing, idle lanes and deletes' second claims: a pending lane wins
    unless a lower pending lane claims a node it claims."""
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 64, 300):
        for _ in range(20):
            pending = t(rng.random(n) < 0.8)
            pred = rng.integers(0, 12, size=n)
            # a delete's second claim is its pred's successor: another node
            second = t(np.where(rng.random(n) < 0.4,
                                (pred + rng.integers(1, 12, size=n)) % 12,
                                -1))
            pred = t(pred)
            got = TB._split_winners(pending, pred, second)
            claims = [({int(pred[i])} | ({int(second[i])} if second[i] >= 0
                                         else set())) for i in range(n)]
            want = [bool(pending[i]) and not any(
                bool(pending[j]) and claims[i] & claims[j]
                for j in range(i)) for i in range(n)]
            assert got.tolist() == want


def test_split_lane_bound():
    """The pairwise winner rule bounds LF-Split at 512 lanes; a wider
    config is refused when it is made."""
    assert TB.SplitConfig(n_lanes=TB.SPLIT_MAX_LANES).n_lanes == 512
    with pytest.raises(ValueError, match="at most 512 lanes"):
        TB.SplitConfig(n_lanes=513)


# ---------------------------------------------------------------------------
# (d) the JAX LF-Split's faults, beside the port's right answer


# identity hash, 4 buckets: keys 1 and 2 sit in bucket 0 in both packages
# and are adjacent in both lists (the JAX package orders them 2, 1)
FAULTS = {
    # deletes of two adjacent nodes in one batch: the JAX package unlinks
    # the first and relinks the second through the first's old link
    "adjacent_deletes": dict(before=[1, 2], kinds=[2, 2], keys=[1, 2],
                             status=[1, 1], jax_found=[True, False],
                             found=[False, False]),
    # a delete of 2 and an insert of 1 after it (JAX order): both win in
    # the JAX package, and the insert is lost
    "delete_and_insert_after": dict(before=[2], kinds=[2, 1], keys=[2, 1],
                                    status=[1, 1], jax_found=[False, False],
                                    found=[True, False]),
}


@pytest.mark.parametrize("case", list(FAULTS))
def test_jax_split_adjacent_conflicts_fault(case):
    c = FAULTS[case]
    jcfg = JB.SplitConfig(depth=2, max_nodes=64, n_lanes=2,
                          hash_name="identity")
    tcfg = port_cfg(jcfg)
    js, ts = JB.split_init(jcfg), TB.split_init(tcfg, "cpu")
    pre = np.zeros(2, np.int32)
    pre[:len(c["before"])] = c["before"]
    pre_kinds = (pre != 0).astype(np.int32)
    js, _, _ = update("split", jcfg, js, pre_kinds, pre, pre)
    ts, _, _ = update("split", tcfg, ts, pre_kinds, pre, pre)
    args = c["kinds"], c["keys"], [7, 9]
    js, jst, _ = update("split", jcfg, js, *args)
    ts, tst, _ = update("split", tcfg, ts, *args)
    assert jst.tolist() == tst.tolist() == c["status"]
    assert lookup("split", jcfg, js, [1, 2])[0].tolist() == c["jax_found"]
    assert lookup("split", tcfg, ts, [1, 2])[0].tolist() == c["found"]
    check_split_list(tcfg, ts, sum(c["found"]))


def test_jax_split_loses_keys_past_max_walk():
    """16,384 inserts at depth 12 with the benchmark's ``max_walk`` 128:
    every status is 1 in both packages, but the JAX package's walks run
    past the bound (every sentinel sorts before every item) and it finds
    fewer than all; the port finds every key."""
    nkeys, n = 16384, 512
    jcfg = JB.SplitConfig(depth=12, max_nodes=2 * nkeys + 4096 + 64,
                          n_lanes=n, max_walk=128)
    tcfg, fns = port_cfg(jcfg), jax_fns(jcfg)
    keys = distinct_keys(np.random.default_rng(5), nkeys)
    js, ts = JB.split_init(jcfg), TB.split_init(tcfg, "cpu")
    ones = np.ones(n, np.int32)
    for i in range(0, nkeys, n):
        k = keys[i:i + n]
        js, jst = fns["update"](js, jnp.asarray(ones), jnp.asarray(k),
                                jnp.asarray(k))
        ts, tst = TB.split_update(tcfg, ts, t(ones), t(k), t(k))
        assert (np.asarray(jst) == 1).all() and (tst == 1).all()
    jfound, _ = fns["lookup"](js, jnp.asarray(keys))
    found, got = TB.split_lookup(tcfg, ts, t(keys))
    assert int(np.asarray(jfound).sum()) < nkeys
    assert bool(found.all()) and torch.equal(got, t(keys))


# ---------------------------------------------------------------------------
# (e, f) contention on one key; EMPTY_KEY is never found


def jax_and_port(kind):
    if kind == "split":
        jcfg = JB.SplitConfig(depth=2, max_nodes=256, n_lanes=4)
        init, tinit = JB.split_init, TB.split_init
    elif kind == "freeze":
        jcfg = JB.FreezeConfig(depth=2, bucket_size=4, pool_size=64,
                               n_lanes=4)
        init, tinit = JB.freeze_init, TB.freeze_init
    else:
        jcfg = JB.LockConfig(depth=2, bucket_size=4, n_lanes=4)
        init, tinit = JB.lock_init, TB.lock_init
    tcfg = port_cfg(jcfg)
    return jcfg, init(jcfg), tcfg, tinit(tcfg, "cpu")


def package(cfg):
    """(module, numpy → array conversion) of the package ``cfg`` is of."""
    if type(cfg).__module__ == TB.__name__:
        return TB, t
    return JB, jnp.asarray


def update(kind, cfg, st, kinds, keys, vals):
    """One write batch of either package; Lock returns its lookups too."""
    mod, conv = package(cfg)
    if mod is JB:
        fn = jax_fns(cfg)["step" if kind == "lock" else "update"]
    else:
        fn = partial({"split": TB.split_update, "freeze": TB.freeze_update,
                      "lock": TB.lock_step}[kind], cfg)
    out = fn(st, *(conv(np.asarray(x, np.int32))
                        for x in (kinds, keys, vals)))
    return out[0], np.asarray(out[1]), out[2:]


def lookup(kind, cfg, st, queries):
    mod, conv = package(cfg)
    q = np.asarray(queries, np.int32)
    if kind == "lock":
        n = cfg.n_lanes
        pad = np.zeros(n, np.int32)
        pad[:len(q)] = q
        _, status, (vout,) = update(kind, cfg, st, np.full(n, 3), pad,
                                    np.zeros(n))
        return status[:len(q)] == 1, np.asarray(vout)[:len(q)]
    if mod is JB:
        found, vals = jax_fns(cfg)["lookup"](st, conv(q))
    else:
        fn = TB.split_lookup if kind == "split" else TB.freeze_lookup
        found, vals = fn(cfg, st, conv(q))
    return np.asarray(found), np.asarray(vals)


@pytest.mark.parametrize("kind", ["split", "freeze", "lock"])
def test_same_key_contention_linearizable(kind):
    """Four lanes upsert one key: exactly one fresh insert, three updates,
    lane for lane as the JAX package, the final value one announced."""
    jcfg, js, tcfg, ts = jax_and_port(kind)
    args = (np.ones(4), np.full(4, 7), [10, 20, 30, 40])
    js, jst, _ = update(kind, jcfg, js, *args)
    ts, tst, _ = update(kind, tcfg, ts, *args)
    assert tst.tolist() == jst.tolist()
    assert (tst == 1).sum() == 1 and (tst == 0).sum() == 3
    found, got = lookup(kind, tcfg, ts, [7])
    assert found[0] and got[0] in (10, 20, 30, 40)
    assert got.tolist() == lookup(kind, jcfg, js, [7])[1].tolist()


@pytest.mark.parametrize("kind", ["split", "freeze", "lock"])
def test_lookup_never_matches_empty_key(kind):
    """``EMPTY_KEY`` is never found, in free slots or on LF-Split's
    sentinels; the JAX LF-Freeze and Lock find it in a free slot."""
    jcfg, js, tcfg, ts = jax_and_port(kind)
    args = (np.ones(4), [3, 5, 8, 13], [1, 2, 3, 4])
    js, _, _ = update(kind, jcfg, js, *args)
    ts, _, _ = update(kind, tcfg, ts, *args)
    found, got = lookup(kind, tcfg, ts, [EMPTY, 3, 4, EMPTY])
    assert found.tolist() == [False, True, False, False]
    assert got.tolist() == [-1, 1, -1, -1]
    assert bool(lookup(kind, jcfg, js, [EMPTY])[0][0]) == (kind != "split")


# ---------------------------------------------------------------------------
# port-only contracts


def test_split_walk_cut_leaves_lane_pending():
    """A walk cut at ``max_walk`` does not splice: the list stays sorted
    and the error flag reports the op that could not finish."""
    cfg = TB.SplitConfig(depth=1, max_nodes=64, n_lanes=1,
                         hash_name="identity", max_walk=3, max_retry=1)
    st = TB.split_init(cfg, "cpu")
    for k in range(1, 6):       # one bucket, in key order: k - 1 steps
        st, status = TB.split_update(cfg, st, t([1]), t([k]), t([k]))
        assert status.tolist() == ([1] if k <= 4 else [-1])
    assert bool(st.error)
    check_split_list(cfg, st, 4)
    assert TB.split_lookup(cfg, st, t([1, 2, 3, 4, 5]))[0].tolist() == [
        True, True, True, True, False]


@pytest.mark.parametrize("kind", ["split", "freeze", "lock"])
def test_entry_points_check_their_inputs(kind):
    _, _, tcfg, ts = jax_and_port(kind)
    with pytest.raises(ValueError, match="n_lanes=4"):
        update(kind, tcfg, ts, np.ones(3), [1, 2, 3], [1, 2, 3])
    init = {"split": TB.split_init, "freeze": TB.freeze_init,
            "lock": TB.lock_init}[kind]
    if torch.cuda.is_available():
        assert init(tcfg).error.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(tcfg)
