"""The port's single-pass fast path ≡ its serial wave loop.

The counterpart of ``tests/test_fastpath.py`` for
``repro_torch.core.table``: ``apply_batch`` with ``use_fast_path=True``
(``_fast_pass``, then the split and wave rounds for what overflows) must
be observationally identical to ``use_fast_path=False`` (the wave loop
alone) — statuses, ``applied_seq``, ``last_status``, the error flag,
``to_dict`` and the per-directory-entry (depth, prefix, item-set)
structure (slot layout inside a bucket is free: lookups, splits and
merges are layout-oblivious). One mix also runs through the JAX
package's ``apply_batch``, which the port's fast path equals array for
array. Everything runs on the CPU.
"""
import dataclasses
from functools import lru_cache, partial

import jax
import numpy as np

from _hyp import given, settings, st  # hypothesis or fallback shim

from repro.core import table as JT
from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict

jax.config.update("jax_platform_name", "cpu")

EMPTY = -2**31


def base_cfg(**kw):
    d = dict(dmax=6, bucket_size=4, pool_size=256, n_lanes=8,
             hash_name="fmix32", initial_depth=0)
    d.update(kw)
    return T.TableConfig(**d)


def pair(cfg):
    """(fast, wave-loop) transactions for one config."""
    assert cfg.use_fast_path
    ref_cfg = dataclasses.replace(cfg, use_fast_path=False)
    return partial(T.apply_batch, cfg), partial(T.apply_batch, ref_cfg)


@lru_cache(maxsize=None)
def jax_apply(cfg):
    return jax.jit(partial(JT.apply_batch, JT.TableConfig(
        **dataclasses.asdict(cfg))))


def structure(cfg, state):
    """Per-directory-entry (depth, prefix, item-set): layout-free contents."""
    s = T.to_numpy(state)
    out = {}
    for e in range(cfg.dcap):
        b = int(s["directory"][e])
        occ = s["keys"][b] != EMPTY
        out[e] = (int(s["bdepth"][b]), int(s["bprefix"][b]),
                  frozenset(zip(s["keys"][b][occ].tolist(),
                                s["vals"][b][occ].tolist())))
    return out


def assert_equivalent(cfg, sf, sr, rf, rr):
    np.testing.assert_array_equal(rf.status.numpy(), rr.status.numpy())
    np.testing.assert_array_equal(sf.applied_seq.numpy(),
                                  sr.applied_seq.numpy())
    np.testing.assert_array_equal(sf.last_status.numpy(),
                                  sr.last_status.numpy())
    assert bool(rf.error) == bool(rr.error)
    assert to_dict(cfg, sf) == to_dict(cfg, sr)
    assert structure(cfg, sf) == structure(cfg, sr)
    check_invariants(cfg, sf, allow_error=bool(rf.error))


def assert_equals_jax(cfg, sf, rf, js, jr):
    """The port's fast path against the JAX package's: statuses and every
    state array but the trash row of the per-bucket arrays."""
    np.testing.assert_array_equal(rf.status.numpy(), np.asarray(jr.status))
    port = T.to_numpy(sf)
    for f in JT.TableState._fields:
        a, b = port[f], np.asarray(getattr(js, f))
        if a.ndim and a.shape[0] == cfg.pool_size + 1:
            a, b = a[:-1], b[:-1]
        np.testing.assert_array_equal(a, b, err_msg=f)


def run_mix(cfg, ins_pct, nsteps, seed, keyspace, with_jax=False):
    apply_f, apply_r = pair(cfg)
    sf, sr = T.init_table(cfg, "cpu"), T.init_table(cfg, "cpu")
    js = JT.init_table(JT.TableConfig(**dataclasses.asdict(cfg)))
    rng = np.random.default_rng(seed)
    n = cfg.n_lanes
    # seed both tables identically so deletes have something to hit
    warm = rng.choice(keyspace, size=n, replace=False).astype(np.int32)
    batches = [(np.full(n, T.INS, np.int32), warm, warm)]
    for _ in range(nsteps):
        is_ins = rng.random(n) < ins_pct / 100.0
        kinds = np.where(is_ins, T.INS, T.DEL).astype(np.int32)
        # small draw pool → frequent intra-batch duplicate keys
        keys = rng.choice(keyspace, size=n).astype(np.int32)
        batches.append((kinds, keys,
                        rng.integers(0, 1000, size=n).astype(np.int32)))
    for i, (kinds, keys, vals) in enumerate(batches):
        ops = T.make_ops(cfg, sf, kinds, keys, vals)
        sf, rf = apply_f(sf, ops)
        sr, rr = apply_r(sr, ops)
        if i:
            assert_equivalent(cfg, sf, sr, rf, rr)
        if with_jax:
            js, jr = jax_apply(cfg)(js, JT.make_ops(
                JT.TableConfig(**dataclasses.asdict(cfg)), js, kinds, keys,
                vals))
            assert_equals_jax(cfg, sf, rf, js, jr)


def test_equivalence_insert_mix_grid():
    """0 / 50 / 100 % inserts, duplicates in every batch; the 50% mix also
    against the JAX package's fast path."""
    keyspace = np.arange(1, 25)  # << lanes*steps → heavy duplication
    for ins_pct in (0, 50, 100):
        run_mix(base_cfg(), ins_pct, nsteps=25, seed=ins_pct,
                keyspace=keyspace, with_jax=ins_pct == 50)


def test_equivalence_overflow_heavy():
    """Tiny buckets: most batches overflow → wave fallback + split pass."""
    cfg = base_cfg(bucket_size=2, dmax=5, pool_size=128, n_lanes=16)
    run_mix(cfg, 80, nsteps=20, seed=7, keyspace=np.arange(1, 40))


def test_equivalence_skewed_identity_hash():
    """Identity hash with clustered top bits: contended bucket groups."""
    cfg = base_cfg(hash_name="identity", bucket_size=2, dmax=6, pool_size=128)
    keyspace = ((np.arange(1, 17) % 4) << 28) | np.arange(1, 17)
    run_mix(cfg, 60, nsteps=20, seed=11, keyspace=keyspace.astype(np.int64))


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_equivalence_property(data):
    """Random configs × random batches, duplicate keys and NOPs included."""
    bucket_size = data.draw(st.sampled_from([2, 4, 8]))
    n_lanes = data.draw(st.sampled_from([4, 8, 16]))
    cfg = base_cfg(bucket_size=bucket_size, n_lanes=n_lanes,
                   dmax=data.draw(st.sampled_from([4, 6])), pool_size=128)
    apply_f, apply_r = pair(cfg)
    sf, sr = T.init_table(cfg, "cpu"), T.init_table(cfg, "cpu")
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    kmax = data.draw(st.sampled_from([6, 20, 200]))
    for _ in range(data.draw(st.integers(1, 8))):
        kinds = rng.integers(0, 3, size=n_lanes).astype(np.int32)
        keys = rng.integers(1, kmax, size=n_lanes).astype(np.int32)
        vals = rng.integers(0, 99, size=n_lanes).astype(np.int32)
        ops = T.make_ops(cfg, sf, kinds, keys, vals)
        sf, rf = apply_f(sf, ops)
        sr, rr = apply_r(sr, ops)
        assert_equivalent(cfg, sf, sr, rf, rr)


def test_equivalence_sorted_links_variant(monkeypatch):
    """Force the sort-based segmented scans (the wide-batch implementation
    of the links contract) and re-run the mix grid: it must match the
    wave loop exactly like the pairwise default does."""
    monkeypatch.setattr(T, "_PAIRWISE_MAX_LANES", 0)
    keyspace = np.arange(1, 25)
    for ins_pct in (0, 50, 100):
        run_mix(base_cfg(n_lanes=16), ins_pct, nsteps=12, seed=ins_pct + 3,
                keyspace=keyspace)
    cfg = base_cfg(bucket_size=2, dmax=5, pool_size=128, n_lanes=16)
    run_mix(cfg, 80, nsteps=12, seed=17, keyspace=np.arange(1, 40))


def test_replay_seqnums_identical_on_fast_path():
    """Exactly-once via the fast path: replayed announcements don't re-run."""
    cfg = base_cfg(n_lanes=4)
    apply_f, apply_r = pair(cfg)
    sf, sr = T.init_table(cfg, "cpu"), T.init_table(cfg, "cpu")
    ops = T.make_ops(cfg, sf, [T.INS, T.INS, 0, 0], [5, 5, 0, 0],
                     [1, 2, 0, 0])                 # duplicate key in batch
    sf, rf = apply_f(sf, ops)
    sr, rr = apply_r(sr, ops)
    assert_equivalent(cfg, sf, sr, rf, rr)
    assert rf.status[:2].tolist() == [T.TRUE, T.FALSE]
    # replay: stored results, no re-execution, on both paths
    sf2, rf2 = apply_f(sf, ops)
    sr2, rr2 = apply_r(sr, ops)
    assert_equivalent(cfg, sf2, sr2, rf2, rr2)
    assert rf2.status.tolist() == rf.status.tolist()
    assert to_dict(cfg, sf2) == {5: 2}


def test_fresh_insert_claims_delete_freed_slot():
    """[DEL k1, INS k2] in one batch where k2's assigned free slot IS the
    slot the delete just cleared: the insert must win (two sequential
    scatters; one combined scatter with duplicate indices has unspecified
    order)."""
    cfg = base_cfg(hash_name="identity", bucket_size=2, dmax=4, pool_size=32,
                   n_lanes=4)
    apply_f, apply_r = pair(cfg)
    k1 = int(np.int32(np.uint32(0x10 << 24)))
    k2 = int(np.int32(np.uint32(0x11 << 24)))
    sf, sr = T.init_table(cfg, "cpu"), T.init_table(cfg, "cpu")
    first = ([T.INS, 0, 0, 0], [k1, 0, 0, 0], [k1, 0, 0, 0])
    sf, _ = apply_f(sf, T.make_ops(cfg, sf, *first))
    sr, _ = apply_r(sr, T.make_ops(cfg, sr, *first))
    batch = ([T.DEL, T.INS, 0, 0], [k1, k2, 0, 0], [0, 77, 0, 0])
    sf, rf = apply_f(sf, T.make_ops(cfg, sf, *batch))
    sr, rr = apply_r(sr, T.make_ops(cfg, sr, *batch))
    assert_equivalent(cfg, sf, sr, rf, rr)
    assert to_dict(cfg, sf) == {k2: 77}
    assert rf.status[:2].tolist() == [T.TRUE, T.TRUE]


def test_counts_survive_merge_roundtrip():
    """Incremental counts stay exact through split → delete → merge, on
    both paths."""
    cfg = base_cfg(hash_name="identity", bucket_size=2, dmax=6, pool_size=64,
                   n_lanes=8)
    ks = [(0x00 << 24) | 1, 0x40 << 24, 0xC0 << 24]
    tables = []
    for apply in pair(cfg):
        s = T.init_table(cfg, "cpu")
        for k in ks + [-ks[0]]:          # three inserts, then a delete
            kinds = np.zeros(8, np.int32)
            keys = np.zeros(8, np.int32)
            kinds[0] = T.INS if k > 0 else T.DEL
            keys[0] = np.int32(np.uint32(abs(k)))
            s, _ = apply(s, T.make_ops(cfg, s, kinds, keys, keys))
            check_invariants(cfg, s)
        s, ok = T.merge_buddies(cfg, s, 0, int(s.depth) - 1)
        assert bool(ok)
        check_invariants(cfg, s)
        assert int(T.table_size(s)) == 2
        tables.append(s)
    assert structure(cfg, tables[0]) == structure(cfg, tables[1])
    np.testing.assert_array_equal(tables[0].counts.numpy(),
                                  tables[1].counts.numpy())
