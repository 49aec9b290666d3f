"""The slow path of a kernel transaction (``kernels/resize.py``).

On the CPU (these count in the suite): the plain transaction's fast pass
applies no lane of the ``ST_FULL`` batch that ``fused_apply_plain`` or
``grouped_apply_plain`` hands the slow path, over seeds and geometries,
which is why the kernel skips it; ``resize_apply``'s CPU route gives
exactly what ``_finish_kernel_apply`` gave when it called
``core/table.py::apply_batch`` itself; the wrapper's argument checks raise
on a wrong dtype, shape or contiguity.

On the card (``cuda``-marked, no JAX in this file): every slow call of a
stream through the kernel path runs through ``resize_apply`` and through
``apply_batch`` on a copy of its inputs, and the two must give the same
statuses and the same state, field by field, at the benchmark's
geometries and over a sweep of widths, bucket sizes and the slow path's
corners; the kernel's rounds and waves equal the plain loop's host counts
and its splits the live buckets it adds. Under pool exhaustion the ops
routed to the trash row are the one named exception: the kernel leaves
them PENDING, the plain passes apply them to row P (see ``card_sweep``):

    python -m pytest -q -m cuda tests/test_torch_resize_apply.py
"""
import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import table as T
from repro_torch.core.hashing import hash_np
from repro_torch.kernels import ops as kops
from repro_torch.kernels import resize as kresize

KERNELS = {"fused": kops._apply_batch_fused_impl,
           "grouped": kops._apply_batch_kernel_impl}
resize_apply = kresize.resize_apply


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def clone(st):
    return type(st)(*(x.clone() for x in st))


def batches(rng, n, steps, universe, kinds=(1, 1, 1, 2), preload=0):
    """``preload`` all-insert batches of distinct keys, then ``steps``
    batches of random kinds over ``universe`` (repeats allowed)."""
    pre = rng.permutation(universe)[:preload * n]
    out = [(np.ones(n, np.int32), pre[i * n:(i + 1) * n])
           for i in range(preload)]
    for _ in range(steps):
        out.append((rng.choice(kinds, size=n).astype(np.int32),
                    rng.choice(universe, size=n).astype(np.int32)))
    return out


def drive(cfg, dev, kernel, stream, on_slow, seed=0, freeze_at=None):
    """Run ``stream`` through a kernel transaction on ``dev``; each slow
    call goes to ``on_slow(cfg, state, ops)``, which returns what the slow
    path returns. ``freeze_at`` freezes every eighth live bucket before
    that step."""
    rng = np.random.default_rng(seed)
    st = T.init_table(cfg, dev)
    kresize.resize_apply = on_slow
    try:
        for step, (kinds, keys) in enumerate(stream):
            if step == freeze_at:
                live = torch.nonzero(st.live[:-1]).flatten()
                st.frozen[live[::8]] = True
            ops = T.make_ops(cfg, st, torch.as_tensor(kinds),
                             torch.as_tensor(keys),
                             torch.as_tensor(rng.integers(
                                 0, 2**31 - 1, size=cfg.n_lanes,
                                 dtype=np.int32)))
            st, _ = KERNELS[kernel](cfg, st, ops)
    finally:
        kresize.resize_apply = resize_apply
    return st


def universe_of(rng, size, hi=1 << 30):
    """``size`` distinct keys in [1, hi), shuffled."""
    keys = np.unique(rng.integers(1, hi, size=2 * size + 64))
    return rng.permutation(keys)[:size].astype(np.int32)


# ---------------------------------------------------------------------------
# CPU: the fast pass does nothing on a kernel's ST_FULL batch

FAST_GEOMS = {
    "b4_n64": dict(dmax=10, bucket_size=4, pool_size=1024, n_lanes=64,
                   initial_depth=1),
    "b8_n300": dict(dmax=12, bucket_size=8, pool_size=2048, n_lanes=300,
                    initial_depth=2),
    "b2_n32_shift3": dict(dmax=8, bucket_size=2, pool_size=512, n_lanes=32,
                          initial_depth=0, hash_shift=3),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("geom", sorted(FAST_GEOMS))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_fast_pass_applies_nothing_on_the_full_set(kernel, geom, seed):
    cfg = T.TableConfig(**FAST_GEOMS[geom])
    P, n = cfg.pool_size, cfg.n_lanes
    rng = np.random.default_rng(seed)
    universe = universe_of(rng, 6 * n)
    seen = []

    def on_slow(cfg, st, ops):
        fresh = (ops.kind != T.NOP) & (ops.seq > st.applied_seq)
        status = torch.full((n,), T.PENDING, dtype=torch.int8)
        before = T.to_numpy(st)
        after, pending, status = T._fast_pass(cfg, clone(st), ops, fresh,
                                              status)
        assert torch.equal(pending, fresh)
        assert (status == T.PENDING).all()
        got = T.to_numpy(after)
        for f in before:
            x, y = before[f], got[f]
            if x.ndim and x.shape[0] == P + 1:
                x, y = x[:P], y[:P]   # the pass's masked writes land in row P
            np.testing.assert_array_equal(x, y, err_msg=f)
        seen.append(int(fresh.sum()))
        return T.apply_batch(cfg, st, ops)

    drive(cfg, "cpu", kernel, batches(rng, n, 8, universe, preload=2),
          on_slow, seed=seed, freeze_at=5)
    assert seen and sum(seen) > 0


# ---------------------------------------------------------------------------
# CPU: the wrapper's CPU route is today's slow path


def _finish_with_apply_batch(cfg, st, ops, status, live, frozen_hit, replay):
    """``_finish_kernel_apply`` as it was when it called the plain
    transaction itself."""
    need_slow = live & (status == kops.ST_FULL)
    slow_status = status
    if bool(need_slow.any()):
        slow_ops = T.OpBatch(kind=torch.where(need_slow, ops.kind, T.NOP),
                             key=ops.key, value=ops.value, seq=ops.seq)
        st, res = T.apply_batch(cfg, st, slow_ops)
        slow_status = res.status
    final = torch.where(need_slow, slow_status, status).to(torch.int8)
    final = torch.where(frozen_hit, T.FROZEN, final).to(torch.int8)
    final = torch.where(replay, st.last_status, final)
    final = torch.where(ops.kind == T.NOP, st.last_status, final)
    st = st._replace(last_status=final)
    return st, T.BatchResult(status=final, error=st.error)


CPU_ROUTE = {
    "fused": ("fused", dict(dmax=10, bucket_size=4, pool_size=512,
                            n_lanes=64, initial_depth=1)),
    "grouped": ("grouped", dict(dmax=12, bucket_size=8, pool_size=2048,
                                n_lanes=1100, initial_depth=1)),
    "no_fast_path": ("fused", dict(dmax=10, bucket_size=4, pool_size=512,
                                   n_lanes=64, initial_depth=1,
                                   use_fast_path=False)),
    "one_round": ("grouped", dict(dmax=10, bucket_size=2, pool_size=512,
                                  n_lanes=300, initial_depth=0,
                                  max_rounds=1)),
    "exhausted": ("fused", dict(dmax=12, bucket_size=4, pool_size=48,
                                n_lanes=96, initial_depth=1)),
}


@pytest.mark.parametrize("case", sorted(CPU_ROUTE))
def test_cpu_route_is_todays_slow_path(monkeypatch, case):
    kernel, geom = CPU_ROUTE[case]
    cfg = T.TableConfig(**geom)
    rng = np.random.default_rng(len(case))
    universe = universe_of(rng, 5 * cfg.n_lanes)
    stream = batches(rng, cfg.n_lanes, 6, universe, preload=2)
    launches = kresize.launches
    calls = []
    def spy(cfg, st, ops):
        calls.append(1)
        return resize_apply(cfg, st, ops)

    states, results = {}, {}
    for name in ("new", "today"):
        if name == "today":
            monkeypatch.setattr(kops, "_finish_kernel_apply",
                                _finish_with_apply_batch)
        st = T.init_table(cfg, "cpu")
        out = []
        vals = np.random.default_rng(1)
        for kinds, keys in stream:
            ops = T.make_ops(cfg, st, torch.as_tensor(kinds),
                             torch.as_tensor(keys), torch.as_tensor(
                                 vals.integers(0, 1000, size=cfg.n_lanes,
                                               dtype=np.int32)))
            with monkeypatch.context() as m:
                m.setattr(kresize, "resize_apply", spy)
                st, res = KERNELS[kernel](cfg, st, ops)
            out.append((res.status.clone(), bool(res.error)))
        states[name], results[name] = T.to_numpy(st), out
    assert calls, "the stream never took the slow path"
    assert kresize.launches == launches
    for (a, ea), (b, eb) in zip(results["new"], results["today"]):
        assert torch.equal(a, b) and ea == eb
    for f, x in states["new"].items():
        np.testing.assert_array_equal(x, states["today"][f], err_msg=f)


# ---------------------------------------------------------------------------
# CPU: argument checks


def _faults():
    def dtype(field, dt):
        return lambda st, ops: (st._replace(**{field: getattr(st, field)
                                               .to(dt)}), ops)

    def op_dtype(field, dt):
        return lambda st, ops: (st, ops._replace(**{field: getattr(ops, field)
                                                    .to(dt)}))

    def shape(field, fn):
        return lambda st, ops: (st._replace(**{field: fn(getattr(st,
                                                                 field))}),
                                ops)

    def strided(t):
        return torch.stack([t, t], -1)[..., 0]

    return {
        "kind_int64": (TypeError, op_dtype("kind", torch.int64)),
        "seq_int8": (TypeError, op_dtype("seq", torch.int8)),
        "directory_int64": (TypeError, dtype("directory", torch.int64)),
        "keys_int64": (TypeError, dtype("keys", torch.int64)),
        "bdepth_int8": (TypeError, dtype("bdepth", torch.int8)),
        "live_uint8": (TypeError, dtype("live", torch.uint8)),
        "depth_int64": (TypeError, dtype("depth", torch.int64)),
        "error_int32": (TypeError, dtype("error", torch.int32)),
        "last_status_int32": (TypeError, dtype("last_status", torch.int32)),
        "directory_short": (ValueError, shape("directory", lambda t: t[1:])),
        "keys_narrow": (ValueError, shape("keys", lambda t: t[:, 1:]
                                          .contiguous())),
        "counts_short": (ValueError, shape("counts", lambda t: t[:-1])),
        "applied_seq_long": (ValueError, shape(
            "applied_seq", lambda t: torch.cat([t, t]))),
        "free_top_1d": (ValueError, shape("free_top", lambda t: t[None])),
        "keys_strided": (ValueError, shape("keys", lambda t: t.t()
                                           .contiguous().t())),
        "free_stack_strided": (ValueError, shape("free_stack", strided)),
        "key_strided": (ValueError, lambda st, ops: (st, ops._replace(
            key=strided(ops.key)))),
    }


FAULTS = _faults()


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_argument_checks_raise(fault):
    cfg = T.TableConfig(dmax=8, bucket_size=4, pool_size=64, n_lanes=16,
                 initial_depth=2)
    st = T.init_table(cfg, "cpu")
    ops = T.make_ops(cfg, st, torch.ones(16, dtype=torch.int32),
                     torch.arange(1, 17, dtype=torch.int32))
    err, bend = FAULTS[fault]
    bad_st, bad_ops = bend(st, ops)
    before = T.to_numpy(st)
    with pytest.raises(err):
        kresize.resize_apply(cfg, bad_st, bad_ops)
    for f, x in T.to_numpy(st).items():   # nothing ran
        np.testing.assert_array_equal(x, before[f], err_msg=f)


def test_a_wrapper_patched_over_the_kernel_keeps_its_count(monkeypatch):
    """The launch count lives on the module: a timer or counter patched
    over ``resize_apply`` (as ``kernels/ops.py`` calls it) leaves the
    telemetry's ``kernel.resize_apply.launches`` readable."""
    calls = []

    def counted(*args):
        calls.append(1)
        return resize_apply(*args)

    monkeypatch.setattr(kresize, "resize_apply", counted)
    cfg = T.TableConfig(dmax=12, bucket_size=2, pool_size=256, n_lanes=32,
                        initial_depth=0)
    st = T.init_table(cfg, "cpu")
    keys = torch.arange(1, 33, dtype=torch.int32)
    with telemetry.collect() as rec:
        st, res = kops._apply_batch_fused_impl(
            cfg, st, T.make_ops(cfg, st, torch.ones(32, dtype=torch.int32),
                                keys, keys))
    assert calls and rec.counters["slow.calls"] == len(calls)
    assert rec.counters["kernel.resize_apply.launches"] == 0   # CPU route
    assert (res.status == T.TRUE).all()


def test_stats_counters_take_one_name_per_element():
    with telemetry.collect() as rec:
        telemetry.count_device(kresize.STATS,
                               torch.tensor([1, 2, 3, 2**31 - 1]))
        telemetry.count_device(kresize.STATS, torch.tensor([4, 0, 1, 2**30]))
    assert {k: rec.counters[k] for k in kresize.STATS} == {
        "slow.rounds": 5, "slow.waves": 2, "slow.splits": 4,
        "slow.dir_writes": 2**31 - 1 + 2**30}


# ---------------------------------------------------------------------------
# the card: resize_apply against apply_batch


def _stats(fn):
    with telemetry.collect() as rec:
        out = fn()
    return out, rec.counters


POOLS = ("keys", "vals", "bdepth", "bprefix", "live", "frozen",
         "free_stack", "counts")
LANES = ("applied_seq", "last_status")


def assert_same(cfg, got_st, got, ref_st, ref, lanes=None):
    """Field by field and lane by lane, on the device (a dmax-30 directory
    is 4 GiB), and on the host where they differ, for the message.
    ``lanes`` (a bool mask) limits the per-lane comparison, and leaves the
    trash row out of the pools."""
    P = cfg.pool_size
    if lanes is not None:
        lanes = torch.as_tensor(lanes, device=got.status.device)
    pairs = [(f, getattr(got_st, f), getattr(ref_st, f))
             for f in T.TableState._fields]
    for f, x, y in pairs + [("status", got.status, ref.status)]:
        if lanes is not None and f in POOLS:
            x, y = x[:P], y[:P]
        if lanes is not None and f in LANES + ("status",):
            x, y = x[lanes], y[lanes]
        if not torch.equal(x, y):
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                          err_msg=f)


def card_sweep(cfg, dev, kernel, stream, freeze_at=None, exhaustion=False,
               freeze_slow=False):
    """Every slow call of ``stream`` through both; returns what was seen:
    the calls, their ST_FULL lanes, each call's free-stack top, the
    statuses, the kernel's rounds and splits, and the lanes routed to the
    trash row."""
    P = cfg.pool_size
    seen = dict(calls=0, lanes=0, free_top=[], status=[], rounds=0,
                splits=0, trash_lanes=0, depth=0, dir_writes=0)

    def on_slow(cfg, st, ops):
        if freeze_slow and seen["calls"] == 0:
            lane = int(torch.nonzero(ops.kind != T.NOP)[0])
            _, bid = T._route(cfg, st.directory, ops.key)
            st.frozen[bid[lane].long()] = True
        ref_in, ops_in = clone(st), T.OpBatch(*(x.clone() for x in ops))
        row_p = (st.keys[P].clone(), st.vals[P].clone())
        live0 = int(st.live[:-1].sum())
        seen["free_top"].append(int(st.free_top))
        (ref_st, ref), c_ref = _stats(lambda: T.apply_batch(cfg, ref_in,
                                                            ops_in))
        launches = kresize.launches
        (got_st, got), c_got = _stats(
            lambda: resize_apply(cfg, st, ops))
        torch.cuda.synchronize()
        assert kresize.launches == launches + 1
        lanes = None
        if exhaustion:
            # ids past the pool clamp to the trash row P, and a directory
            # range whose children clamped sends its ops there. The kernel
            # never applies them (they stay PENDING, error set) and never
            # writes row P's slots; the plain passes apply them to row P,
            # which their masked entries overwrite too (in no fixed order
            # on the card), and report them applied. A lane routed there
            # only after it applied (its bucket split later in the call)
            # agrees. Every other lane, every row but P, the directory and
            # the error flag agree.
            h = hash_np(cfg.hash_name, ops.key.cpu().numpy(), cfg.hash_shift)
            routed = ((T.to_numpy(got_st)["directory"][h >> (32 - cfg.dmax)]
                       == P) & (ops.kind != T.NOP).cpu().numpy())
            held = routed & (got.status.cpu().numpy() == T.PENDING)
            lanes = ~held
            assert not routed.any() or bool(got.error)
            assert torch.equal(got_st.keys[P], row_p[0])
            assert torch.equal(got_st.vals[P], row_p[1])
            seen["trash_lanes"] += int(held.sum())
        assert_same(cfg, got_st, got, ref_st, ref, lanes)
        assert c_got["kernel.resize_apply.launches"] == 1
        if lanes is None or lanes.all():
            # held lanes keep the kernel's rounds going to the bound
            for k in ("slow.rounds", "slow.waves", "slow.dir_writes"):
                assert c_got.get(k, 0) == c_ref.get(k, 0), k
        if not bool(ref_st.error):
            assert c_got.get("slow.splits", 0) == (
                int(got_st.live[:-1].sum()) - live0)
        seen["calls"] += 1
        seen["lanes"] += int((ops.kind != T.NOP).sum())
        seen["rounds"] += c_got.get("slow.rounds", 0)
        seen["splits"] += c_got.get("slow.splits", 0)
        seen["dir_writes"] += c_got.get("slow.dir_writes", 0)
        seen["depth"] = max(seen["depth"], int(got_st.depth))
        seen["status"].append(got.status.cpu().numpy())
        return got_st, got

    drive(cfg, dev, kernel, stream, on_slow, freeze_at=freeze_at)
    assert seen["calls"] > 0 and seen["lanes"] > 0
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["paper-int", "ycsb-1kb"])
def test_card_benchmark_geometries(cuda, name):
    """The benchmark configurations' geometries: a load of 2**17 keys, then
    mixed writes (``paper-int``: 4,096 lanes, ``grouped_apply``;
    ``ycsb-1kb``: 1,024 lanes, ``fused_apply``)."""
    n, kernel, depth = ((4096, "grouped", 14) if name == "paper-int"
                        else (1024, "fused", 16))
    cfg = T.TableConfig(dmax=20, bucket_size=8, pool_size=2**20, n_lanes=n,
                 initial_depth=depth)
    rng = np.random.default_rng(20)
    universe = universe_of(rng, 2**18)
    stream = batches(rng, n, 4, universe, kinds=(1, 2),
                     preload=2**17 // n)
    seen = card_sweep(cfg, cuda, kernel, stream)
    assert seen["splits"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n,preload", [("fused", 1024, 4),
                                              ("grouped", 4096, 1)])
def test_card_dmax_30(cuda, kernel, n, preload):
    """A 30-bit directory (2**30 entries, 4 GiB): 4,096 keys under eight
    20-bit hash prefixes (identity hash) load into depth-20 buckets and
    split them to depth 21 and past, then mixed writes; every slow call's
    statuses and state, directory included, as ``apply_batch``'s, and its
    directory writes as the plain pass counts them."""
    cfg = T.TableConfig(dmax=30, bucket_size=8, pool_size=2**20 + 2**14,
                        n_lanes=n, initial_depth=20, hash_name="identity")
    rng = np.random.default_rng(30 + n)
    prefixes = rng.choice(np.arange(1, 1 << 19), size=8, replace=False)
    universe = rng.permutation(((prefixes[:, None] << 12)
                                | np.arange(1 << 12)).ravel()
                               ).astype(np.int32)
    stream = batches(rng, n, 2, universe, kinds=(1, 1, 2), preload=preload)
    seen = card_sweep(cfg, cuda, kernel, stream)
    assert seen["splits"] > 0 and seen["depth"] >= 23
    assert seen["dir_writes"] >= seen["splits"] * 2**(30 - seen["depth"])


SWEEP = [(n, b) for n in (16, 1024, 4096) for b in (4, 8, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", SWEEP)
def test_card_width_and_bucket_sweep(cuda, n, B):
    cfg = T.TableConfig(dmax=14, bucket_size=B, pool_size=2**14, n_lanes=n,
                 initial_depth=2)
    rng = np.random.default_rng(n + B)
    universe = universe_of(rng, max(4 * n, 64 * B), hi=1 << 24)
    steps = 24 if n == 16 else 6
    seen = card_sweep(cfg, cuda, "grouped" if n > 1024 else "fused",
                      batches(rng, n, steps, universe, preload=2))
    assert seen["splits"] > 0
    assert max(seen["free_top"]) > 0   # splits popped a non-empty stack


# name: (kernel, geometry, stream options, card_sweep options)
CORNERS = {
    "hash_shift": ("fused", dict(dmax=12, bucket_size=8, pool_size=4096,
                                 n_lanes=512, initial_depth=1,
                                 hash_shift=3), {}, {}),
    "hash_shift_grouped": ("grouped", dict(dmax=12, bucket_size=4,
                                           pool_size=4096, n_lanes=2048,
                                           initial_depth=1, hash_shift=5),
                           {}, {}),
    "frozen_and_duplicates": ("fused", dict(dmax=12, bucket_size=4,
                                            pool_size=4096, n_lanes=256,
                                            initial_depth=2),
                              dict(universe=600), dict(freeze_at=4,
                                                       freeze_slow=True)),
    "deletes_behind_full_inserts": ("grouped", dict(
        dmax=12, bucket_size=4, pool_size=4096, n_lanes=1100,
        initial_depth=2), dict(kinds=(1, 2), universe=1500), {}),
    "overflow_at_dmax": ("fused", dict(dmax=5, bucket_size=2, pool_size=256,
                                       n_lanes=128, initial_depth=1), {},
                         {}),
    # exhaustion: ids clamp to the trash row P; row P and the lanes the
    # kernel holds PENDING there are left out of the comparison (see
    # card_sweep)
    "pool_exhaustion": ("fused", dict(dmax=12, bucket_size=4, pool_size=48,
                                      n_lanes=128, initial_depth=1), {},
                        dict(exhaustion=True)),
    "max_rounds_leaves_pending": ("grouped", dict(
        dmax=12, bucket_size=2, pool_size=4096, n_lanes=1100,
        initial_depth=0, max_rounds=1), {}, {}),
    "no_fast_path": ("fused", dict(dmax=12, bucket_size=4, pool_size=4096,
                                   n_lanes=512, initial_depth=1,
                                   use_fast_path=False),
                     dict(universe=1200), dict(freeze_at=3)),
    "wide_scratch_8192": ("grouped", dict(dmax=16, bucket_size=8,
                                          pool_size=2**15, n_lanes=8192,
                                          initial_depth=4), {}, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CORNERS))
def test_card_corners(cuda, name):
    kernel, geom, sopt, copt = CORNERS[name]
    cfg = T.TableConfig(**geom)
    n = cfg.n_lanes
    rng = np.random.default_rng(len(name))
    universe = universe_of(rng, sopt.get("universe", 4 * n), hi=1 << 24)
    stream = batches(rng, n, 6, universe, kinds=sopt.get("kinds",
                                                         (1, 1, 1, 2)),
                     preload=1 if sopt.get("universe") else 2)
    seen = card_sweep(cfg, cuda, kernel, stream, **copt)
    status = np.concatenate(seen["status"])
    if name == "overflow_at_dmax":
        assert (status == T.OVERFLOW).any()
    if name == "max_rounds_leaves_pending":
        assert (status == T.PENDING).any()
    if name.startswith("frozen"):
        assert (status == T.FROZEN).any()
    if name == "wide_scratch_8192":
        assert kresize._scratch_bytes(n) > 0
    if name == "pool_exhaustion":
        assert seen["trash_lanes"] > 0


@pytest.mark.cuda
def test_card_exhaustion_clamps_ids(cuda):
    """The pool runs out mid-split: ``error`` set, ``nalloc`` at the pool,
    a directory entry pointing at the trash row."""
    cfg = T.TableConfig(dmax=12, bucket_size=4, pool_size=48, n_lanes=128,
                 initial_depth=1)
    rng = np.random.default_rng(7)
    universe = universe_of(rng, 1024, hi=1 << 24)
    out = []

    def on_slow(cfg, st, ops):
        st, res = resize_apply(cfg, st, ops)
        out.append(st)
        return st, res

    st = drive(cfg, cuda, "fused", batches(rng, 128, 4, universe, preload=2),
               on_slow)
    assert bool(st.error) and int(st.nalloc) == cfg.pool_size
    assert (st.directory == cfg.pool_size).any()
