"""The PyTorch port's combining transaction against the JAX package.

Every plan of the port runs here on the CPU: ``"plain"`` (the plain
transaction, ``core/table.py::apply_batch``), ``"cuda"`` (the fused kernel
path of ``kernels/ops.py``) and ``"grouped"`` (the ``"cuda"`` backend with
``fused_lookup = fused_apply = False``, the unfused path a wide-lane table
takes: route and sort around ``grouped_apply``, route then ``probe``); the
kernels run their plain versions on CPU tensors. The same seeded op
streams — overflow and split batches (B=2), duplicate keys, replayed
sequence numbers, frozen buckets via ``freeze_buddies``, and
``merge_buddies`` — go through the port and through
``repro.core.table.apply_batch``:

* statuses are lane-exact, lookups equal ``repro.core.table.lookup`` and
  ``to_dict`` content is equal;
* under ``"plain"`` every state array except the trash row is equal;
* under ``"cuda"`` / ``"grouped"`` every state array except the trash row
  equals the JAX package's fused / grouped kernel path
  (``kernels/ops.py::_apply_batch_fused_impl`` /
  ``_apply_batch_kernel_impl`` with the ``fused_apply_ref`` / ``apply_ref``
  oracle in place of the Pallas kernel); against ``apply_batch`` the pool
  rows agree as sets, because the lane-order combiner and the single fast
  pass may put a fresh insert in different free slots of the same bucket;
* the JAX package's ``check_invariants`` passes on ``to_numpy(state)``.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import table as JT
from repro.core.hashing import dir_index
from repro.core.invariants import check_invariants as jax_check_invariants
from repro.core.invariants import to_dict as jax_to_dict
from repro.core.reference import SeqExtHash
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro_torch.core import table as TT
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.kernels import ops as tops
from repro_torch.kernels.plan import KernelPlan

jax.config.update("jax_platform_name", "cpu")

POOL_FIELDS = ("keys", "vals")
PER_BUCKET = ("keys", "vals", "bdepth", "bprefix", "live", "frozen",
              "counts", "free_stack")


def np_state(st) -> dict:
    return {f: np.asarray(getattr(st, f)) for f in JT.TableState._fields}


def sorted_rows(keys, vals):
    order = np.argsort(keys, axis=1, kind="stable")
    return (np.take_along_axis(keys, order, 1),
            np.take_along_axis(vals, order, 1))


def assert_same_state(port: dict, ref: dict, P: int, rows_as_sets=False,
                      where=""):
    """Every field equal except the trash row (index P of the per-bucket
    arrays); with ``rows_as_sets``, pool rows are compared as sets."""
    for f in JT.TableState._fields:
        a, b = port[f], ref[f]
        if f in PER_BUCKET:
            a, b = a[:P], b[:P]
        if rows_as_sets and f in POOL_FIELDS:
            continue
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")
    if rows_as_sets:
        for a, b, name in zip(sorted_rows(port["keys"][:P], port["vals"][:P]),
                              sorted_rows(ref["keys"][:P], ref["vals"][:P]),
                              POOL_FIELDS):
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def jax_kernel_path(cfg, state, ops):
    """The JAX package's fused kernel transaction with the kernel's oracle
    in place of the Pallas launch (which JAX 0.9 cannot interpret)."""
    fresh = (ops.kind != JT.NOP) & (ops.seq > state.applied_seq)
    replay = (ops.kind != JT.NOP) & ~fresh
    kinds = jnp.where(fresh, ops.kind, JT.NOP)
    pk, pv, status, bid = kref.fused_apply_ref(
        state.directory, state.frozen, kinds, ops.key, ops.value,
        state.keys, state.vals, dmax=cfg.dmax, hash_name=cfg.hash_name,
        hash_shift=cfg.hash_shift)
    frozen_hit = fresh & (status == kref.ST_FROZEN)
    live = fresh & ~frozen_hit
    applied = live & (status != kref.ST_FULL)
    hit = applied & (status == JT.TRUE)
    delta = (jnp.where(hit & (ops.kind == JT.INS), 1, 0)
             - jnp.where(hit & (ops.kind == JT.DEL), 1, 0))
    counts = state.counts.at[
        jnp.where(applied, bid, jnp.int32(cfg.pool_size))].add(delta)
    counts = counts.at[cfg.pool_size].set(0)
    st = state._replace(keys=pk, vals=pv, counts=counts,
                        applied_seq=jnp.where(applied | frozen_hit, ops.seq,
                                              state.applied_seq))
    return jops._finish_kernel_apply(cfg, st, ops, status.astype(jnp.int8),
                                     live, frozen_hit, replay)


def jax_grouped_path(cfg, state, ops):
    """The JAX package's grouped kernel transaction
    (``kernels/ops.py::_apply_batch_kernel_impl``) with the kernel's oracle
    ``apply_ref`` in place of the Pallas launch (which JAX 0.9 cannot
    interpret)."""
    n = cfg.n_lanes
    fresh = (ops.kind != JT.NOP) & (ops.seq > state.applied_seq)
    replay = (ops.kind != JT.NOP) & ~fresh
    bid = state.directory[dir_index(cfg.hash_fn(ops.key), cfg.dmax)]
    frozen_hit = fresh & state.frozen[bid]
    live = fresh & ~frozen_hit
    kinds = jnp.where(live, ops.kind, 0)
    order = jnp.argsort(jnp.where(live, bid, jnp.int32(cfg.pool_size + 1)),
                        stable=True)
    inv = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n,
                                                           dtype=jnp.int32))
    pk, pv, status_sorted = kref.apply_ref(
        kinds[order], ops.key[order], ops.value[order], bid[order],
        state.keys[:-1], state.vals[:-1])
    status = status_sorted[inv]
    applied = live & (status != kref.ST_FULL)
    hit = applied & (status == jnp.int8(JT.TRUE))
    delta = (jnp.where(hit & (ops.kind == JT.INS), 1, 0)
             - jnp.where(hit & (ops.kind == JT.DEL), 1, 0))
    counts = state.counts.at[
        jnp.where(applied, bid, jnp.int32(cfg.pool_size))].add(delta)
    counts = counts.at[cfg.pool_size].set(0)
    st = state._replace(keys=state.keys.at[:-1].set(pk),
                        vals=state.vals.at[:-1].set(pv), counts=counts,
                        applied_seq=jnp.where(applied | frozen_hit, ops.seq,
                                              state.applied_seq))
    return jops._finish_kernel_apply(cfg, st, ops, status.astype(jnp.int8),
                                     live, frozen_hit, replay)


@lru_cache(maxsize=None)
def jax_fns(cfg):
    return {"apply": jax.jit(partial(JT.apply_batch, cfg)),
            "cuda": jax.jit(partial(jax_kernel_path, cfg)),
            "grouped": jax.jit(partial(jax_grouped_path, cfg)),
            "lookup": jax.jit(partial(JT.lookup, cfg)),
            "freeze": jax.jit(partial(JT.freeze_buddies, cfg)),
            "merge": jax.jit(partial(JT.merge_buddies, cfg))}


PLANS = {"plain": KernelPlan("plain"), "cuda": KernelPlan("cuda"),
         "grouped": KernelPlan("cuda", fused_lookup=False,
                               fused_apply=False)}


def port_apply(backend, cfg, state, ops):
    return tops.plan_apply(PLANS[backend], cfg, state, ops)


def check_both_checkers(tcfg, jcfg, ts):
    snap = TT.to_numpy(ts)
    err = bool(snap["error"])
    check_invariants(tcfg, snap, allow_error=err)
    jst = JT.TableState(**{f: jnp.asarray(v) for f, v in snap.items()})
    jax_check_invariants(jcfg, jst, allow_error=err)


def buddy_parent(snap, rng, P):
    """A (parent_prefix, parent_depth) whose children are live buckets."""
    cand = np.nonzero(snap["live"][:P] & (snap["bdepth"][:P] >= 1))[0]
    if not cand.size:
        return None
    b = int(rng.choice(cand))
    return int(snap["bprefix"][b]) >> 1, int(snap["bdepth"][b]) - 1


def drive(backend, cfg_kw, steps, seed, key_hi, replay_every=5,
          freeze_every=4, merge_every=6):
    """Run one seeded stream through the port and the JAX references,
    comparing after every transaction, freeze and merge."""
    jcfg, tcfg = JT.TableConfig(**cfg_kw), TT.TableConfig(**cfg_kw)
    P, n = jcfg.pool_size, jcfg.n_lanes
    fns = jax_fns(jcfg)
    rng = np.random.default_rng(seed)
    js = JT.init_table(jcfg)            # JAX apply_batch
    jk = JT.init_table(jcfg)            # JAX kernel path of this backend
    ts = TT.init_table(tcfg, "cpu")
    qrng = np.random.default_rng(seed + 1)
    seen, prev = set(), None
    for step in range(steps):
        if prev is not None and step % replay_every == replay_every - 1:
            kinds, keys, vals, seq = prev        # replayed seqs: no re-exec
        else:
            kinds = rng.integers(0, 3, size=n).astype(np.int32)
            keys = rng.integers(1, key_hi, size=n).astype(np.int32)
            vals = rng.integers(0, 1 << 20, size=n).astype(np.int32)
            seq = np.asarray(js.applied_seq) + 1
        prev = kinds, keys, vals, seq
        jo = JT.OpBatch(*(jnp.asarray(x) for x in (kinds, keys, vals, seq)))
        to = TT.OpBatch(*(torch.tensor(x) for x in (kinds, keys, vals,
                                                        seq)))
        js, jr = fns["apply"](js, jo)
        ts, tr = port_apply(backend, tcfg, ts, to)
        where = f"{backend} step {step}"
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status),
                                      err_msg=where)
        assert bool(tr.error) == bool(jr.error), where
        assert to_dict(tcfg, ts) == jax_to_dict(jcfg, js), where
        q = qrng.integers(1, key_hi, size=2 * n).astype(np.int32)
        for port_x, jax_x in zip(
                tops.plan_lookup(PLANS[backend], tcfg, ts, torch.tensor(q)),
                fns["lookup"](js, jnp.asarray(q))):
            np.testing.assert_array_equal(port_x.numpy(), np.asarray(jax_x),
                                          err_msg=where + " lookup")
        if backend == "plain":
            assert_same_state(TT.to_numpy(ts), np_state(js), P, where=where)
        else:
            jk, kr = fns[backend](jk, jo)
            np.testing.assert_array_equal(tr.status.numpy(),
                                          np.asarray(kr.status), err_msg=where)
            assert_same_state(TT.to_numpy(ts), np_state(jk), P, where=where)
            assert_same_state(TT.to_numpy(ts), np_state(js), P,
                              rows_as_sets=True, where=where)
        seen |= set(tr.status.tolist())
        check_both_checkers(tcfg, jcfg, ts)

        snap = TT.to_numpy(ts)
        for every, name in ((freeze_every, "freeze"), (merge_every, "merge")):
            if step % every != every - 1:
                continue
            parent = buddy_parent(snap, rng, P)
            if parent is None:
                continue
            refs = [(js, "js")] + ([(jk, "jk")] if backend != "plain"
                                   else [])
            outs = {tag: fns[name](s, *parent) for s, tag in refs}
            ts, tok = getattr(TT, f"{name}_buddies")(tcfg, ts, *parent)
            js, jok = outs["js"]
            if backend != "plain":
                jk, _ = outs["jk"]
            assert bool(tok) == bool(jok), f"{where} {name} {parent}"
            assert_same_state(TT.to_numpy(ts), np_state(js), P,
                              rows_as_sets=backend != "plain",
                              where=f"{where} {name}")
            check_both_checkers(tcfg, jcfg, ts)
    return seen


BASE = dict(dmax=6, bucket_size=2, pool_size=64, n_lanes=8)


@pytest.mark.parametrize("backend", ["plain", "cuda", "grouped"])
def test_overflow_split_stream_b2(backend):
    """B=2: most batches overflow and split; frozen buckets and merges."""
    seen = drive(backend, BASE, steps=30, seed=3, key_hi=120)
    assert {JT.TRUE, JT.FALSE, JT.FROZEN} <= seen


@pytest.mark.parametrize("backend", ["plain", "cuda", "grouped"])
def test_wide_lanes_sorted_links(backend):
    """300 lanes cross _PAIRWISE_MAX_LANES: the sorted segmented scans."""
    cfg = dict(dmax=8, bucket_size=4, pool_size=256, n_lanes=300)
    seen = drive(backend, cfg, steps=7, seed=4, key_hi=900,
                 freeze_every=3, merge_every=4)
    assert {JT.TRUE, JT.FALSE} <= seen


def test_grouped_plan_hands_grouped_apply_lane_order(monkeypatch):
    """The ``"grouped"`` plan passes the routed ops to ``grouped_apply``
    (spied) in lane order, unsorted, with the frozen and replayed lanes
    masked to NOP; the transaction still equals ``jax_grouped_path``, which
    sorts them by (bucket, lane)."""
    cfg_kw = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=48)
    jcfg, tcfg = JT.TableConfig(**cfg_kw), TT.TableConfig(**cfg_kw)
    P, n = jcfg.pool_size, jcfg.n_lanes
    fns = jax_fns(jcfg)
    calls = []
    real = tops.kapply.grouped_apply

    def spy(*args, **kw):
        calls.append([a.clone() for a in args[:4]])
        return real(*args, **kw)

    monkeypatch.setattr(tops.kapply, "grouped_apply", spy)
    rng = np.random.default_rng(21)
    jk, ts = JT.init_table(jcfg), TT.init_table(tcfg, "cpu")
    masked = {"frozen": 0, "replay": 0, "unsorted": 0}
    prev = None
    for step in range(10):
        kinds = rng.integers(0, 3, size=n).astype(np.int32)
        keys = rng.integers(1, 300, size=n).astype(np.int32)
        vals = rng.integers(0, 1 << 20, size=n).astype(np.int32)
        seq = np.asarray(jk.applied_seq) + 1
        if step % 4 == 3:       # half the lanes replay the previous batch
            again = rng.random(n) < 0.5
            kinds, keys, vals, seq = (np.where(again, p, x) for p, x in
                                      zip(prev, (kinds, keys, vals, seq)))
        prev = kinds, keys, vals, seq
        if step == 2:
            parent = buddy_parent(TT.to_numpy(ts), rng, P)
            ts, tok = TT.freeze_buddies(tcfg, ts, *parent)
            jk, jok = fns["freeze"](jk, *parent)
            assert bool(tok) and bool(jok)
        to = TT.OpBatch(*(torch.tensor(x) for x in (kinds, keys, vals, seq)))
        jo = JT.OpBatch(*(jnp.asarray(x) for x in (kinds, keys, vals, seq)))
        _, bid = TT._route(tcfg, ts.directory, to.key)
        fresh = (to.kind != TT.NOP) & (to.seq > ts.applied_seq)
        frozen_hit = fresh & ts.frozen[bid.long()]
        want_kinds = torch.where(fresh & ~frozen_hit, to.kind, TT.NOP)
        masked["frozen"] += int(frozen_hit.sum())
        masked["replay"] += int(((to.kind != TT.NOP) & ~fresh).sum())

        ts, tr = port_apply("grouped", tcfg, ts, to)
        jk, kr = fns["grouped"](jk, jo)
        where = f"step {step}"
        np.testing.assert_array_equal(tr.status.numpy(),
                                      np.asarray(kr.status), err_msg=where)
        assert_same_state(TT.to_numpy(ts), np_state(jk), P, where=where)

        g_kinds, g_keys, g_vals, g_bids = calls[-1]
        assert torch.equal(g_keys, to.key) and torch.equal(g_vals, to.value)
        assert torch.equal(g_bids, bid) and torch.equal(g_kinds, want_kinds)
        active = g_bids[g_kinds != TT.NOP]
        masked["unsorted"] += int((active[1:] < active[:-1]).any())
    assert len(calls) == 10
    assert all(v > 0 for v in masked.values()), masked


def test_wave_loop_stream_no_fast_path():
    """use_fast_path=False pins the serial wave loop in both packages."""
    drive("plain", dict(BASE, use_fast_path=False, bucket_size=4), steps=20,
          seed=5, key_hi=150)


def test_dmax_exhaustion_sets_overflow_and_error():
    """identity hash + keys sharing their top bits: splits run out of hash
    bits, the ops report OVERFLOW and the error flag is set, as in JAX."""
    cfg = dict(dmax=3, bucket_size=2, pool_size=32, n_lanes=8,
               hash_name="identity")
    jcfg, tcfg = JT.TableConfig(**cfg), TT.TableConfig(**cfg)
    keys = np.arange(1, 9, dtype=np.int32)      # all in entry 0
    kinds = np.full(8, JT.INS, np.int32)
    js, jr = jax_fns(jcfg)["apply"](
        JT.init_table(jcfg), JT.make_ops(jcfg, JT.init_table(jcfg), kinds,
                                         keys, keys))
    for backend in PLANS:
        ts = TT.init_table(tcfg, "cpu")
        ts, tr = port_apply(backend, tcfg, ts,
                            TT.make_ops(tcfg, ts, kinds, keys, keys))
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        assert (tr.status.numpy() == JT.OVERFLOW).any() and bool(tr.error)
        assert to_dict(tcfg, ts) == jax_to_dict(jcfg, js)


@pytest.mark.parametrize("backend", ["plain", "cuda", "grouped"])
def test_single_op_batches_match_sequential_oracle(backend):
    """One op per transaction must follow SeqExtHash exactly: statuses,
    content and the per-entry (depth, prefix, items) layout."""
    cfg = TT.TableConfig(dmax=6, bucket_size=4, pool_size=256, n_lanes=8)
    oracle = SeqExtHash(6, 4)
    ts = TT.init_table(cfg, "cpu")
    rng = np.random.default_rng(9)
    for step in range(150):
        kind = JT.INS if rng.random() < 0.7 else JT.DEL
        key, val = int(rng.integers(1, 80)), int(rng.integers(0, 99))
        lane = step % 8
        kinds, keys, vals = (np.zeros(8, np.int32) for _ in range(3))
        kinds[lane], keys[lane], vals[lane] = kind, key, val
        ts, res = port_apply(backend, cfg, ts,
                             TT.make_ops(cfg, ts, kinds, keys, vals))
        want = oracle.insert(key, val) if kind == JT.INS else \
            oracle.delete(key)
        assert int(res.status[lane]) == want, step
    assert to_dict(cfg, ts) == oracle.as_dict()
    snap = TT.to_numpy(ts)
    layout = {}
    for e, b in enumerate(snap["directory"]):
        occ = snap["keys"][b] != TT.EMPTY_KEY
        layout[e] = (int(snap["bdepth"][b]), int(snap["bprefix"][b]),
                     frozenset(zip(snap["keys"][b][occ].tolist(),
                                   snap["vals"][b][occ].tolist())))
    assert layout == oracle.layout()
    assert int(snap["depth"]) == oracle.depth


def test_numpy_round_trip_from_jax_state_with_frozen_bucket():
    """from_numpy_state(JAX state) → to_numpy gives the same arrays, and
    a frozen bucket carried across blocks updates in the port too."""
    jcfg = JT.TableConfig(dmax=5, bucket_size=4, pool_size=32, n_lanes=8,
                          initial_depth=2)
    tcfg = TT.TableConfig(dmax=5, bucket_size=4, pool_size=32, n_lanes=8,
                          initial_depth=2)
    js, ok = JT.freeze_buddies(jcfg, JT.init_table(jcfg), 0, 1)
    assert bool(ok)
    ts = TT.from_numpy_state(np_state(js), "cpu")
    assert_same_state(TT.to_numpy(ts), np_state(js), jcfg.pool_size + 1)
    keys = np.arange(1, 9, dtype=np.int32)
    kinds = np.full(8, JT.INS, np.int32)
    js, jr = jax_fns(jcfg)["apply"](js, JT.make_ops(jcfg, js, kinds, keys,
                                                    keys))
    for backend in PLANS:
        t2 = TT.from_numpy_state(TT.to_numpy(ts), "cpu")
        t2, tr = port_apply(backend, tcfg, t2,
                            TT.make_ops(tcfg, t2, kinds, keys, keys))
        np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
        assert (tr.status.numpy() == JT.FROZEN).any()


def test_make_ops_and_pad_ops_like_jax():
    """The announce helpers: NOP padding, fresh seqs, shape validation."""
    jcfg = JT.TableConfig(dmax=4, bucket_size=2, pool_size=16, n_lanes=8)
    tcfg = TT.TableConfig(dmax=4, bucket_size=2, pool_size=16, n_lanes=8)
    kinds, keys = np.array([1, 2, 1], np.int32), np.array([5, 6, 7], np.int32)
    for a, b in zip(TT.pad_ops(tcfg, kinds, keys, device="cpu"),
                    JT.pad_ops(jcfg, kinds, keys)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts = TT.init_table(tcfg, "cpu")
    ops = TT.make_ops(tcfg, ts, *TT.pad_ops(tcfg, kinds, keys, device="cpu"))
    assert ops.seq.tolist() == [1] * 8
    with pytest.raises(ValueError):
        TT.make_ops(tcfg, ts, kinds, keys)             # short batch
    with pytest.raises(ValueError):
        TT.pad_ops(tcfg, np.ones(9, np.int32), np.ones(9, np.int32),
                   device="cpu")                       # over-length batch
    with pytest.raises(ValueError):
        TT.pad_ops(tcfg, kinds, keys[:2], device="cpu")  # mismatched
