"""The PyTorch port's kernels: plain versions against the JAX package, and
the CUDA kernels against their plain versions.

On the CPU the kernel wrappers run their plain versions, which must equal
the JAX references exactly (integers, tolerance 0):
``fused_probe_plain`` ≡ ``repro.kernels.lookup.fused_probe`` in interpret
mode, ``probe_plain`` ≡ ``repro.kernels.lookup.probe`` in interpret mode
and ``ref.probe_ref``, ``fused_apply_plain`` ≡
``repro.kernels.ref.fused_apply_ref`` and ``grouped_apply_plain`` ≡
``ref.apply_ref`` (the Pallas apply kernels themselves cannot run in
interpret mode on JAX 0.9, which dropped ``pl.load``/``pl.store``). The
``cuda``-marked tests launch the CUDA kernels on the card and compare them
with the plain versions; they skip where there is no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.hashing import EMPTY_KEY, hash_np
from repro_torch.kernels import apply as tapply
from repro_torch.kernels import lookup as tlookup
from repro_torch.kernels import tuning

try:
    import jax
    import jax.numpy as jnp

    from repro.core import table as JT
    from repro.kernels import lookup as jlookup
    from repro.kernels import ref as kref
    jax.config.update("jax_platform_name", "cpu")
except ModuleNotFoundError:
    # the GPU machine has no JAX: there only the cuda-marked tests run
    # (python -m pytest -m cuda tests/test_torch_kernels.py)
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")
ST_IDLE, ST_FALSE, ST_TRUE, ST_FROZEN, ST_FULL = (
    tapply.ST_IDLE, tapply.ST_FALSE, tapply.ST_TRUE, tapply.ST_FROZEN,
    tapply.ST_FULL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# seeded cases (numpy, shared by both frameworks)


def probe_case(rng, dmax, P, B, N, hash_name="fmix32", hash_shift=0):
    """Directory, pools with unique keys per row, and queries: about half
    hits (keys placed in the row their hash routes to), misses, an EMPTY
    query and the extreme keys ±(2**31 - 1)."""
    directory = rng.integers(0, P, size=1 << dmax).astype(np.int32)
    keys = np.full((P, B), EMPTY_KEY, np.int32)
    vals = rng.integers(-2**31, 2**31, size=(P, B),
                        dtype=np.int64).astype(np.int32)
    q = rng.integers(-2**31 + 1, 2**31, size=N, dtype=np.int64).astype(
        np.int32)
    q[:3] = [EMPTY_KEY, 2**31 - 1, -2**31 + 1]
    rows = directory[(hash_np(hash_name, q, hash_shift)
                      >> np.uint32(32 - dmax)).astype(np.int64)]
    for i in range(1, N):
        if rng.random() < 0.5:
            free = np.nonzero(keys[rows[i]] == EMPTY_KEY)[0]
            if free.size and q[i] not in keys[rows[i]]:
                keys[rows[i], free[0]] = q[i]
    filler = rng.random((P, B)) < 0.3
    keys[filler & (keys == EMPTY_KEY)] = -7   # never queried (distinct rows)
    return directory, q, keys, vals


def fused_case(rng, dmax, P, B, fill=0.6, frozen_frac=0.25):
    """Directory, frozen mask and [P+1, B] pools, as the JAX package's
    ``tests/test_kernels.py::random_fused_case`` (ops: ``fused_ops``)."""
    directory = rng.integers(0, P, size=1 << dmax).astype(np.int32)
    frozen = np.zeros(P + 1, bool)
    frozen[:P] = rng.random(P) < frozen_frac
    pk = np.full((P + 1, B), EMPTY_KEY, np.int32)
    pv = np.zeros((P + 1, B), np.int32)
    for p in range(P + 1):
        k = rng.choice(np.arange(1, 10_000), size=B, replace=False)
        occ = rng.random(B) < fill
        pk[p, occ] = k[occ]
        pv[p, occ] = rng.integers(0, 1 << 20, size=occ.sum())
    return directory, frozen, pk, pv


def fused_ops(rng, n, key_hi=64, ins_frac=None):
    if ins_frac is None:
        kinds = rng.integers(0, 3, size=n).astype(np.int32)
    else:
        kinds = np.where(rng.random(n) < ins_frac, 1, 2).astype(np.int32)
    keys = rng.integers(1, key_hi, size=n).astype(np.int32)
    values = rng.integers(0, 1 << 15, size=n).astype(np.int32)
    return kinds, keys, values


def t(x, device="cpu"):
    return torch.tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# fused probe: plain version ≡ JAX fused_probe (interpret)


@needs_jax
@pytest.mark.parametrize("dmax,P,B,N,hash_name,shift", [
    (4, 16, 4, 64, "fmix32", 0),
    (6, 64, 8, 300, "fmix32", 1),
    (7, 100, 8, 257, "identity", 0),
    (8, 200, 8, 512, "fmix32", 0),
    (8, 130, 16, 200, "identity", 1),
])
def test_fused_probe_plain_matches_jax_kernel(dmax, P, B, N, hash_name,
                                              shift):
    rng = np.random.default_rng(dmax * 100 + N)
    directory, q, pk, pv = probe_case(rng, dmax, P, B, N, hash_name, shift)
    jf, jv = jlookup.fused_probe(
        jnp.asarray(directory), jnp.asarray(q), jnp.asarray(pk),
        jnp.asarray(pv), dmax=dmax, hash_name=hash_name, hash_shift=shift,
        interpret=True)
    tf, tv = tlookup.fused_probe(t(directory), t(q), t(pk), t(pv),
                                 dmax=dmax, hash_name=hash_name,
                                 hash_shift=shift)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < int(tf.sum()) < N      # hits and misses both exercised
    assert tlookup.fused_probe.launches == 0   # CPU tensors: no launch


@needs_jax
def test_empty_query_never_matches():
    """The kernel contract the port follows: an EMPTY_KEY query is never
    found, even when its row has free slots. ``repro.core.table.lookup``
    (and ``ref.probe_ref``) would match it to a free slot instead."""
    dmax, P, B = 4, 8, 4
    directory = np.arange(1 << dmax, dtype=np.int32) % P
    pk = np.full((P, B), EMPTY_KEY, np.int32)
    pk[:, 0] = np.arange(1, P + 1)
    pv = np.arange(P * B, dtype=np.int32).reshape(P, B)
    q = np.array([EMPTY_KEY, 3, EMPTY_KEY], np.int32)
    tf, tv = tlookup.fused_probe_plain(t(directory), t(q), t(pk), t(pv),
                                       dmax=dmax)
    jf, jv = jlookup.fused_probe(jnp.asarray(directory), jnp.asarray(q),
                                 jnp.asarray(pk), jnp.asarray(pv),
                                 dmax=dmax, interpret=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tf[0] and not tf[2] and tv[0] == -1
    # the divergence, pinned: the JAX transaction-side lookup finds it
    cfg = JT.TableConfig(dmax=dmax, bucket_size=B, pool_size=P, n_lanes=4)
    found, _ = JT.lookup(cfg, JT.init_table(cfg), jnp.asarray(q[:1]))
    assert bool(found[0])


# ---------------------------------------------------------------------------
# fused apply: plain version ≡ fused_apply_ref over carried rounds


def run_fused_rounds(rng, dmax, P, B, n, *, fill, frozen_frac=0.25,
                     key_hi=64, ins_frac=None, rounds=3):
    """Carry the pools through ``rounds`` batches in both frameworks; live
    rows, statuses and bucket ids must match exactly (the trash row is
    unspecified by contract). Returns every round's statuses."""
    directory, frozen, pk, pv = fused_case(rng, dmax, P, B, fill,
                                           frozen_frac)
    jpk, jpv = jnp.asarray(pk), jnp.asarray(pv)
    tpk, tpv = t(pk), t(pv)
    seen = []
    for r in range(rounds):
        kinds, keys, values = fused_ops(rng, n, key_hi, ins_frac)
        jpk, jpv, jst, jbid = kref.fused_apply_ref(
            jnp.asarray(directory), jnp.asarray(frozen), jnp.asarray(kinds),
            jnp.asarray(keys), jnp.asarray(values), jpk, jpv, dmax=dmax)
        tpk, tpv, tst, tbid = tapply.fused_apply(
            t(directory), t(frozen), t(kinds), t(keys), t(values), tpk, tpv,
            dmax=dmax)
        np.testing.assert_array_equal(tbid.numpy(), np.asarray(jbid),
                                      err_msg=f"round {r}: bucket ids")
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"round {r}: status")
        np.testing.assert_array_equal(tpk.numpy()[:P], np.asarray(jpk)[:P],
                                      err_msg=f"round {r}: pool keys")
        np.testing.assert_array_equal(tpv.numpy()[:P], np.asarray(jpv)[:P],
                                      err_msg=f"round {r}: pool vals")
        seen.append(tst.numpy())
    return np.concatenate(seen)


@needs_jax
@pytest.mark.parametrize("dmax,P,B,n,fill", [
    (6, 16, 4, 8, 0.5),
    (6, 64, 8, 32, 0.6),
    (8, 100, 8, 64, 0.5),     # non-power-of-two P
    (6, 32, 16, 16, 0.95),    # near-full pools → ST_FULL
    (4, 8, 4, 8, 1.0),        # everything full
])
def test_fused_apply_plain_matches_ref(dmax, P, B, n, fill):
    rng = np.random.default_rng(dmax * 1000 + P + n)
    status = run_fused_rounds(rng, dmax, P, B, n, fill=fill)
    assert status.size == 3 * n


@needs_jax
@pytest.mark.parametrize("ins_frac", [0.0, 0.5, 1.0])
def test_fused_apply_plain_duplicate_keys(ins_frac):
    """Heavy intra-batch duplicate keys (~3 lanes per key): the lane-order
    combine within a bucket group is the only order that matters."""
    rng = np.random.default_rng(int(ins_frac * 7) + 11)
    run_fused_rounds(rng, 6, 32, 4, 32, fill=0.5, key_hi=12,
                     ins_frac=ins_frac, rounds=2)


@needs_jax
def test_fused_apply_plain_status_space_covered():
    """All five statuses — TRUE, FALSE, FULL, FROZEN, IDLE — in one
    adversarial geometry (alternating sparse and packed pools)."""
    rng = np.random.default_rng(5)
    seen = np.concatenate([
        run_fused_rounds(rng, 5, 16, 4, 64, fill=0.45 if trial % 2 else 0.95,
                         frozen_frac=0.4, key_hi=32, rounds=2)
        for trial in range(4)])
    for code in (ST_IDLE, ST_FALSE, ST_TRUE, ST_FROZEN, ST_FULL):
        assert (seen == code).any(), f"status {code} never produced"


# ---------------------------------------------------------------------------
# pre-routed probe: plain version ≡ JAX probe (interpret) ≡ probe_ref


def routed_case(rng, P, B, N):
    """Pools with distinct keys per row and pre-routed queries: about half
    hit their row, the rest miss; no query is ``EMPTY_KEY`` (``probe_ref``
    would match it to a free slot)."""
    pk = np.full((P, B), EMPTY_KEY, np.int32)
    pv = rng.integers(-2**31, 2**31, size=(P, B),
                      dtype=np.int64).astype(np.int32)
    for p in range(P):
        k = rng.choice(np.arange(1, 4 * B * 8), size=B, replace=False)
        occ = rng.random(B) < 0.7
        pk[p, occ] = k[occ]
    bids = rng.integers(0, P, size=N).astype(np.int32)
    q = rng.integers(1, 4 * B * 8, size=N).astype(np.int32)
    hit = rng.random(N) < 0.5
    for i in np.nonzero(hit)[0]:
        live = pk[bids[i]][pk[bids[i]] != EMPTY_KEY]
        if live.size:
            q[i] = rng.choice(live)
    q[:2] = [2**31 - 1, -2**31 + 1]
    return bids, q, pk, pv


@needs_jax
@pytest.mark.parametrize("P,B,N", [(16, 4, 64), (100, 8, 300),
                                   (700, 8, 513), (50, 16, 200)])
def test_probe_plain_matches_jax_kernel_and_ref(P, B, N):
    rng = np.random.default_rng(P * 10 + N)
    bids, q, pk, pv = routed_case(rng, P, B, N)
    jargs = [jnp.asarray(x) for x in (bids, q, pk, pv)]
    jf, jv = jlookup.probe(*jargs, interpret=True)
    rf, rv = kref.probe_ref(*jargs)
    tf, tv = tlookup.probe(t(bids), t(q), t(pk), t(pv))
    for f, v in ((jf, jv), (rf, rv)):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(f))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    assert 0 < int(tf.sum()) < N
    assert tlookup.probe.launches == 0          # CPU tensors: no launch


def test_probe_plain_never_finds_empty_query():
    pk = torch.full((4, 4), EMPTY_KEY, dtype=torch.int32)
    pv = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    f, v = tlookup.probe(torch.tensor([0, 3], dtype=torch.int32),
                         torch.tensor([EMPTY_KEY, 5], dtype=torch.int32),
                         pk, pv)
    assert f.tolist() == [False, False] and v.tolist() == [-1, -1]


def route(directory, q, dmax):
    return directory[(hash_np("fmix32", q) >> np.uint32(32 - dmax))
                     .astype(np.int64)]


def slot_case(rng, dmax, P, B, *, empty_frac=0.05, duplicates=False):
    """Every row filled by keys that route to it, then about a fifth of the
    slots emptied, so rows have holes. Queries: every live key once (a hit
    at every slot position), as many keys never placed, and ``empty_frac``
    of ``EMPTY_KEY`` queries. With ``duplicates``, every third row repeats
    its first key in its last slot under another value, so only the first
    matching slot answers right (not for the Pallas ``probe``, which sums
    the matches)."""
    directory = (rng.permutation(1 << dmax) % P).astype(np.int32)
    cand = rng.permutation(np.unique(rng.integers(
        -2**31 + 1, 2**31, size=4 * P * B, dtype=np.int64))).astype(np.int32)
    rows = route(directory, cand, dmax)
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    start = np.r_[0, np.nonzero(r[1:] != r[:-1])[0] + 1]
    rank = np.arange(r.size) - np.repeat(start, np.diff(np.r_[start, r.size]))
    ok = rank < B
    pk = np.full((P, B), EMPTY_KEY, np.int32)
    pk[r[ok], rank[ok]] = cand[order][ok]
    pv = rng.integers(-2**31, 2**31, size=(P, B),
                      dtype=np.int64).astype(np.int32)
    pk[rng.random((P, B)) < 0.2] = EMPTY_KEY
    if duplicates:
        pk[::3, B - 1] = pk[::3, 0]
    live = pk[pk != EMPTY_KEY]
    missing = cand[order][~ok][: live.size]
    q = rng.permutation(np.r_[live, missing]).astype(np.int32)
    q[rng.random(q.size) < empty_frac] = EMPTY_KEY
    return directory, q, pk, pv


def first_slots(bids, q, pk):
    """The first matching slot of every query that hits its row."""
    eq = (pk[bids] == q[:, None]) & (q != EMPTY_KEY)[:, None]
    return eq.argmax(axis=1)[eq.any(axis=1)]


@needs_jax
@pytest.mark.parametrize("B", [4, 8, 32])
def test_probe_plains_match_jax_at_every_slot(B):
    """Both plain probes, against which the kernels' in-register pick of
    the first matching slot is held on the card, equal the JAX kernels on
    hits at every slot position of rows with holes."""
    dmax, P = 8, 48
    rng = np.random.default_rng(B)
    directory, q, pk, pv = slot_case(rng, dmax, P, B)
    bids = route(directory, q, dmax)
    assert set(first_slots(bids, q, pk).tolist()) == set(range(B))
    jargs = [jnp.asarray(x) for x in (q, pk, pv)]
    jf, jv = jlookup.fused_probe(jnp.asarray(directory), *jargs, dmax=dmax,
                                 interpret=True)
    tf, tv = tlookup.fused_probe_plain(t(directory), t(q), t(pk), t(pv),
                                       dmax=dmax)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jf, jv = jlookup.probe(jnp.asarray(bids), *jargs, interpret=True)
    rf, rv = tlookup.probe_plain(t(bids), t(q), t(pk), t(pv))
    np.testing.assert_array_equal(rf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jv))
    assert 0 < int(tf.sum()) < q.size and torch.equal(tf, rf)


def test_build_load_sets_up_each_entry_point_once(monkeypatch):
    """A kernel wrapper asks ``_build.load`` for its entry point at every
    launch: the library is opened and the types are set only the first
    time for each (source, function)."""
    import ctypes
    import types

    from repro_torch.kernels import _build

    opened = []

    class FakeLib:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, name):
            return types.SimpleNamespace(name=name)

    monkeypatch.setattr(_build, "build_all", lambda: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_entry_points", {})
    a = _build.load("probe.cu", "probe_launch", [ctypes.c_int])
    assert a.argtypes == [ctypes.c_int] and a.restype is ctypes.c_int
    a.argtypes = None
    assert _build.load("probe.cu", "probe_launch", [ctypes.c_int]) is a
    assert a.argtypes is None and len(opened) == 1
    b = _build.load("fused_probe.cu", "fused_probe_launch", [])
    assert b is not a and b.name == "fused_probe_launch"
    assert len(opened) == 2


# ---------------------------------------------------------------------------
# grouped apply: plain version ≡ apply_ref over carried rounds


def lane_order_ops(rng, m, rows, key_hi, idle_frac=0.2, ins_frac=0.5):
    """``m`` ops over ``rows`` in lane order, as the table hands them to
    ``grouped_apply``: buckets interleaved, idle lanes (with real bucket
    ids) between the active lanes of one bucket."""
    kinds = np.where(rng.random(m) < ins_frac, 1, 2).astype(np.int32)
    kinds[rng.random(m) < idle_frac] = 0
    bids = rng.choice(rows, size=m).astype(np.int32)
    keys = rng.integers(1, key_hi, size=m).astype(np.int32)
    values = rng.integers(0, 1 << 20, size=m).astype(np.int32)
    return [kinds, keys, values, bids]


def grouped_ops(rng, m, rows, key_hi, idle_frac=0.2, ins_frac=0.5):
    """``lane_order_ops`` sorted by (bucket, lane) as the JAX package sorts
    them: the active ops by bucket, then the idle lanes, which keep real
    bucket ids (so they collide with live runs)."""
    ops = lane_order_ops(rng, m, rows, key_hi, idle_frac, ins_frac)
    kinds, bids = ops[0], ops[3]
    order = np.argsort(np.where(kinds != 0, bids, rows.max() + 2),
                       kind="stable")
    return [x[order] for x in ops]


def run_grouped_rounds(rng, P, B, m, *, fill, key_hi, n_rows=None,
                       rounds=3, idle_frac=0.2, ins_frac=0.5,
                       make_ops=grouped_ops):
    """Carry [P+1, B] pools through ``rounds`` batches from ``make_ops``
    in the port and [P, B] pools through ``apply_ref``: statuses and rows
    0..P-1 must match exactly. Returns every round's (statuses, kinds)."""
    _, _, pk, pv = fused_case(rng, 4, P, B, fill, 0.0)
    rows = rng.choice(P, size=n_rows or P, replace=False)
    jpk, jpv = jnp.asarray(pk[:P]), jnp.asarray(pv[:P])
    tpk, tpv = t(pk), t(pv)
    seen, kinds = [], []
    for r in range(rounds):
        ops = make_ops(rng, m, rows, key_hi, idle_frac, ins_frac)
        kinds.append(ops[0])
        jpk, jpv, jst = kref.apply_ref(*(jnp.asarray(x) for x in ops),
                                       jpk, jpv)
        tpk, tpv, tst = tapply.grouped_apply(*(t(x) for x in ops), tpk, tpv)
        assert tst.dtype == torch.int8
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst),
                                      err_msg=f"round {r}: status")
        np.testing.assert_array_equal(tpk.numpy()[:P], np.asarray(jpk),
                                      err_msg=f"round {r}: pool keys")
        np.testing.assert_array_equal(tpv.numpy()[:P], np.asarray(jpv),
                                      err_msg=f"round {r}: pool vals")
        seen.append(tst.numpy())
    assert tapply.grouped_apply.launches == 0   # CPU tensors: no launch
    return np.concatenate(seen), np.concatenate(kinds)


@needs_jax
@pytest.mark.parametrize("P,B,m,fill,n_rows", [
    (16, 4, 32, 0.5, None),
    (64, 8, 128, 0.6, 12),     # few rows: long runs per bucket
    (100, 8, 200, 0.95, None),  # near-full rows → ST_FULL, deletes included
    (32, 40, 64, 0.9, 8),      # rows wider than the register path
])
def test_grouped_apply_plain_matches_apply_ref(P, B, m, fill, n_rows):
    rng = np.random.default_rng(P + B + m)
    seen, _ = run_grouped_rounds(rng, P, B, m, fill=fill, key_hi=40,
                                 n_rows=n_rows)
    assert (seen == ST_IDLE).any() and (seen == ST_TRUE).any()


def interleaved_runs(kinds, bids):
    """Buckets whose active ops are not consecutive, and those with an idle
    lane between two of their active ops."""
    split, idle_between = set(), set()
    for b in np.unique(bids[kinds != 0]):
        lanes = np.nonzero((kinds != 0) & (bids == b))[0]
        if lanes[-1] - lanes[0] + 1 > lanes.size:
            split.add(int(b))
            if (kinds[lanes[0]:lanes[-1]] == 0).any():
                idle_between.add(int(b))
    return split, idle_between


@needs_jax
@pytest.mark.parametrize("P,B,m,fill,n_rows,key_hi", [
    (16, 4, 48, 0.5, 5, 12),      # few rows: long interleaved runs
    (64, 8, 200, 0.7, 20, 30),
    (100, 8, 300, 0.95, None, 40),  # near-full rows → ST_FULL
    (24, 40, 96, 0.9, 6, 30),     # rows wider than the register path
])
def test_grouped_apply_plain_lane_order_matches_apply_ref(P, B, m, fill,
                                                          n_rows, key_hi):
    """Ops in lane order, unsorted, as ``kernels/ops.py`` now hands them
    over: ``grouped_apply_plain`` equals ``apply_ref`` on the same ops, with
    buckets interleaved, idle lanes between one bucket's active lanes and
    duplicate keys."""
    batches = []

    def make_ops(*args):
        batches.append(lane_order_ops(*args))
        return batches[-1]

    rng = np.random.default_rng(P * 7 + m)
    seen, _ = run_grouped_rounds(rng, P, B, m, fill=fill, key_hi=key_hi,
                                 n_rows=n_rows, make_ops=make_ops)
    assert (seen == ST_IDLE).any() and (seen == ST_FALSE).any()
    for kinds, keys, _, bids in batches:
        split, idle_between = interleaved_runs(kinds, bids)
        assert split and idle_between
        active_keys = keys[kinds != 0]
        assert np.unique(active_keys).size < active_keys.size


@needs_jax
@pytest.mark.parametrize("ins_frac", [0.0, 0.5, 1.0])
def test_grouped_apply_plain_duplicate_keys(ins_frac):
    """Few keys on few rows: duplicate keys within a run, and deletes on
    full rows (``ST_FULL`` even for a delete)."""
    rng = np.random.default_rng(int(ins_frac * 10) + 3)
    seen, _ = run_grouped_rounds(rng, 16, 4, 64, fill=0.3, key_hi=10,
                                 n_rows=4, ins_frac=ins_frac, rounds=2)
    assert (seen == ST_FALSE).any()
    assert (seen == ST_TRUE).any() == (ins_frac > 0)


@needs_jax
def test_grouped_apply_plain_status_space_covered():
    """TRUE, FALSE, FULL and IDLE in one carried stream, with deletes that
    meet full rows."""
    rng = np.random.default_rng(8)
    seen, kinds = run_grouped_rounds(rng, 24, 4, 96, fill=0.5, key_hi=24,
                                     n_rows=10, rounds=4)
    for code in (ST_IDLE, ST_FALSE, ST_TRUE, ST_FULL):
        assert (seen == code).any(), f"status {code} never produced"
    assert ((kinds == 2) & (seen == ST_FULL)).any()


def test_wrappers_reject_bad_arguments():
    directory = torch.zeros(16, dtype=torch.int32)
    pk = torch.full((5, 4), EMPTY_KEY, dtype=torch.int32)
    pv = torch.zeros((5, 4), dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tlookup.fused_probe(directory, q, pk, pv, dmax=3)
    with pytest.raises(TypeError):
        tlookup.fused_probe(directory, q.long(), pk, pv, dmax=4)
    with pytest.raises(ValueError):
        tapply.fused_apply(directory, torch.zeros(5, dtype=torch.bool), q, q,
                           q[:2], pk, pv, dmax=4)
    with pytest.raises(ValueError):
        tapply.fused_apply(directory, torch.zeros(5, dtype=torch.bool), q, q,
                           q, pk.t(), pv.t(), dmax=4)
    with pytest.raises(ValueError):
        tlookup.probe(q[:2], q, pk, pv)
    with pytest.raises(TypeError):
        tapply.grouped_apply(q, q, q, q.long(), pk, pv)
    with pytest.raises(ValueError):
        tapply.grouped_apply(q, q, q[:2], q, pk, pv)


# ---------------------------------------------------------------------------
# CUDA kernels ≡ their plain versions (on the card)


# cases of the row probe both kernels share (csrc/row_probe.cuh): hits at
# every slot position of 4-, 8- and 32-slot rows (the vector row path), an
# 8-slot pool whose keys or values start 4 bytes off a 16-byte boundary
# (the slot-by-slot path), and half the queries EMPTY; rows hold a key twice
ROW_CASES = [("slots", 4), ("slots", 8), ("slots", 32), ("keys_off16", 8),
             ("vals_off16", 8), ("empty", 8)]


def at_offset(x, device):
    """``x`` as a contiguous [R, B] tensor at storage offset 1, so that its
    base is 4 bytes off a 16-byte boundary."""
    buf = torch.empty(x.size + 1, dtype=torch.int32, device=device)
    view = buf[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def row_case(case, B, dmax, P, device):
    """(directory, bucket ids, queries, pool keys, pool values) of one of
    ``ROW_CASES`` on ``device``."""
    rng = np.random.default_rng(B)
    directory, q, pk, pv = slot_case(
        rng, dmax, P, B, duplicates=True,
        empty_frac=0.5 if case == "empty" else 0.05)
    bids = route(directory, q, dmax)
    assert set(first_slots(bids, q, pk).tolist()) == set(range(B))
    pk_t = at_offset(pk, device) if case == "keys_off16" else t(pk, device)
    pv_t = at_offset(pv, device) if case == "vals_off16" else t(pv, device)
    return t(directory, device), t(bids, device), t(q, device), pk_t, pv_t


@pytest.mark.cuda
@pytest.mark.parametrize("dmax,P,B,N,case", [
    (6, 64, 8, 1000, "random"), (10, 700, 4, 333, "random"),
    (16, 1 << 14, 8, 1 << 16, "random"),
    *[(12, 1000, B, None, case) for case, B in ROW_CASES]])
def test_cuda_fused_probe_equals_plain(cuda, dmax, P, B, N, case):
    if case == "random":
        rng = np.random.default_rng(N)
        args = [t(x, cuda) for x in probe_case(rng, dmax, P, B, N)]
    else:
        directory, _, q, pk, pv = row_case(case, B, dmax, P, cuda)
        args = [directory, q, pk, pv]
    before = tlookup.fused_probe.launches
    kf, kv = tlookup.fused_probe(*args, dmax=dmax)
    pf, pv_ = tlookup.fused_probe_plain(*args, dmax=dmax)
    torch.cuda.synchronize()
    assert tlookup.fused_probe.launches == before + 1
    assert torch.equal(kf, pf) and torch.equal(kv, pv_)
    assert 0 < int(kf.sum()) < args[1].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dmax,P,B,n,fill,key_hi,one_bucket", [
    (5, 16, 4, 64, 0.95, 64, False),
    (8, 100, 8, 512, 0.6, 64, False),
    (6, 32, 16, 1024, 0.8, 64, False),
    (8, 100, 32, 512, 0.6, 200, False),   # 32-slot rows
    (6, 32, 8, 1024, 0.3, 64, True),      # every lane on one bucket
    (6, 32, 32, 777, 0.3, 20, True),      # ... which never fills
])
def test_cuda_fused_apply_equals_plain(cuda, dmax, P, B, n, fill, key_hi,
                                       one_bucket):
    rng = np.random.default_rng(n + P)
    directory, frozen, pk, pv = fused_case(rng, dmax, P, B, fill)
    if one_bucket:
        directory[:] = 3
        frozen[3] = False
    d, fr = t(directory, cuda), t(frozen, cuda)
    kpk, kpv, ppk, ppv = (t(x, cuda) for x in (pk, pv, pk, pv))
    for r in range(3):
        ops = [t(x, cuda) for x in fused_ops(rng, n, key_hi)]
        before = tapply.fused_apply.launches
        _, _, kst, kbid = tapply.fused_apply(d, fr, *ops, kpk, kpv, dmax=dmax)
        _, _, pst, pbid = tapply.fused_apply_plain(d, fr, *ops, ppk, ppv,
                                                   dmax=dmax)
        torch.cuda.synchronize()
        assert tapply.fused_apply.launches == before + 1
        assert torch.equal(kst, pst) and torch.equal(kbid, pbid), r
        assert torch.equal(kpk[:P], ppk[:P]) and torch.equal(kpv[:P],
                                                             ppv[:P]), r
        assert torch.equal(kpk[P], t(pk[P], cuda)), r   # trash row untouched
        assert torch.equal(kpv[P], t(pv[P], cuda)), r


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,N,case", [
    (64, 8, 1000, "random"), (700, 4, 333, "random"),
    (1 << 14, 8, 1 << 16, "random"), (40, 40, 500, "random"),
    *[(1000, B, None, case) for case, B in ROW_CASES]])
def test_cuda_probe_equals_plain(cuda, P, B, N, case):
    if case == "random":
        rng = np.random.default_rng(N + B)
        args = [t(x, cuda) for x in routed_case(rng, P, B, N)]
    else:
        args = row_case(case, B, 12, P, cuda)[1:]
    before = tlookup.probe.launches
    kf, kv = tlookup.probe(*args)
    pf, pv_ = tlookup.probe_plain(*args)
    torch.cuda.synchronize()
    assert tlookup.probe.launches == before + 1
    assert torch.equal(kf, pf) and torch.equal(kv, pv_)
    assert 0 < int(kf.sum()) < args[1].shape[0]


CHUNK = tapply.GROUPED_CHUNK


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,m,fill,n_rows,key_hi,order", [
    (16, 4, 64, 0.95, 6, 60, "sorted"),
    (100, 8, 4096, 0.6, None, 60, "sorted"),
    (64, 16, 3000, 0.8, 20, 60, "sorted"),
    (32, 40, 500, 0.9, 8, 60, "sorted"),
    (16, 4, 64, 0.95, 6, 60, "lane"),
    (100, 8, 4096, 0.6, None, 60, "lane"),
    (64, 16, 3000, 0.8, 20, 60, "lane"),
    (32, 40, 500, 0.9, 8, 60, "lane"),
    # wider than one chunk: every bucket's ops span the chunk borders, on
    # 32-slot rows that never fill (at most 19 keys on about 10 of them)
    (2000, 32, 3 * CHUNK + 17, 0.3, 300, 20, "lane"),
    # every lane on one bucket, across a chunk border; the 32-slot row
    # never fills, the 8-slot one does
    (16, 32, CHUNK + 17, 0.3, 1, 20, "lane"),
    (16, 8, 2 * CHUNK, 0.3, 1, 20, "lane"),
])
def test_cuda_grouped_apply_equals_plain(cuda, P, B, m, fill, n_rows, key_hi,
                                         order):
    rng = np.random.default_rng(m + P)
    _, _, pk, pv = fused_case(rng, 4, P, B, fill, 0.0)
    rows = rng.choice(P, size=n_rows or P, replace=False)
    make_ops = grouped_ops if order == "sorted" else lane_order_ops
    kpk, kpv, ppk, ppv = (t(x, cuda) for x in (pk, pv, pk, pv))
    for r in range(3):
        ops = [t(x, cuda) for x in make_ops(rng, m, rows, key_hi)]
        before = tapply.grouped_apply.launches
        _, _, kst = tapply.grouped_apply(*ops, kpk, kpv)
        _, _, pst = tapply.grouped_apply_plain(*ops, ppk, ppv)
        torch.cuda.synchronize()
        assert tapply.grouped_apply.launches == before + 1
        assert torch.equal(kst, pst), r
        assert torch.equal(kpk[:P], ppk[:P]) and torch.equal(kpv[:P],
                                                             ppv[:P]), r
        assert torch.equal(kpk[P], t(pk[P], cuda)), r   # trash row untouched
        assert torch.equal(kpv[P], t(pv[P], cuda)), r


# ---------------------------------------------------------------------------
# every launch shape (kernels/tuning.py) ≡ the plain versions (on the card)

BLOCKS, CHUNKS = tuning.BLOCKS, tuning.CHUNKS


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case,B", [("random", 8), ("slots", 8),
                                    ("slots", 32), ("keys_off16", 8),
                                    ("empty", 8)])
def test_cuda_probes_every_block_equal_plain(cuda, block, case, B):
    """Both probes at every block size, on the vector and the slot-by-slot
    row paths, over more queries than one block holds."""
    dmax, P = 12, 1000
    if case == "random":
        rng = np.random.default_rng(block + B)
        directory, q, pk, pv = (t(x, cuda) for x in probe_case(
            rng, dmax, P, B, 5000))
        bids = t(route(directory.cpu().numpy(), q.cpu().numpy(), dmax), cuda)
    else:
        directory, bids, q, pk, pv = row_case(case, B, dmax, P, cuda)
    for name, first, kw in (("fused_probe", directory, dict(dmax=dmax)),
                            ("probe", bids, {})):
        kernel = getattr(tlookup, name)
        plain = getattr(tlookup, f"{name}_plain")
        before = kernel.launches
        kf, kv = kernel(first, q, pk, pv, block=block, **kw)
        pf, pv_ = plain(first, q, pk, pv, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(kf, pf) and torch.equal(kv, pv_), name
        assert 0 < int(kf.sum()) < q.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("P,B,m,fill,n_rows,key_hi", [
    (100, 8, 4096, 0.6, None, 60),
    (64, 16, 3000, 0.8, 20, 60),
    (32, 40, 500, 0.9, 8, 60),          # rows in memory
    # every bucket's ops span the borders of every chunk size
    (2000, 32, 3 * 4096 + 17, 0.3, 300, 20),
    (16, 8, 2 * 4096 + 5, 0.3, 1, 20),  # every lane on one bucket
])
def test_cuda_grouped_apply_every_chunk_equals_plain(cuda, chunk, P, B, m,
                                                     fill, n_rows, key_hi):
    rng = np.random.default_rng(m + P + chunk)
    _, _, pk, pv = fused_case(rng, 4, P, B, fill, 0.0)
    rows = rng.choice(P, size=n_rows or P, replace=False)
    kpk, kpv, ppk, ppv = (t(x, cuda) for x in (pk, pv, pk, pv))
    for r in range(3):
        ops = [t(x, cuda) for x in lane_order_ops(rng, m, rows, key_hi)]
        before = tapply.grouped_apply.launches
        _, _, kst = tapply.grouped_apply(*ops, kpk, kpv, chunk=chunk)
        _, _, pst = tapply.grouped_apply_plain(*ops, ppk, ppv)
        torch.cuda.synchronize()
        assert tapply.grouped_apply.launches == before + 1
        assert torch.equal(kst, pst), r
        assert torch.equal(kpk[:P], ppk[:P]) and torch.equal(kpv[:P],
                                                             ppv[:P]), r
        assert torch.equal(kpk[P], t(pk[P], cuda)), r   # trash row untouched
        assert torch.equal(kpv[P], t(pv[P], cuda)), r


@pytest.mark.cuda
def test_cuda_entry_points_reject_unknown_tiles(cuda):
    """The C entry points refuse a tile outside their set with
    cudaErrorInvalidValue (1) and launch nothing, even for an empty
    batch; the wrappers refuse it before reaching them."""
    from repro_torch.kernels import _build
    z = torch.zeros(16, dtype=torch.int32, device=cuda)
    pools = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    out = torch.zeros(16, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    fused = _build.load("fused_probe.cu", "fused_probe_launch",
                        tlookup._FUSED_ARGTYPES)
    probe = _build.load("probe.cu", "probe_launch", tlookup._PROBE_ARGTYPES)
    grouped = _build.load("grouped_apply.cu", "grouped_apply_launch",
                          tapply._GROUPED_ARGTYPES)
    p = [x.data_ptr() for x in (z, z, pools, pools, out, out)]
    for n in (0, 16):
        for threads, rc in ((48, 1), (512, 1), (0, 1), (64, 0)):
            assert fused(*p, n, 4, 4, 0, 0, threads, stream) == rc
            assert probe(*p, n, 4, threads, stream) == rc
        for chunk, rc in ((512, 1), (3000, 1), (8192, 1), (4096, 0)):
            assert grouped(*[z.data_ptr()] * 4, pools.data_ptr(),
                           pools.data_ptr(), out.data_ptr(), n, 4, 4, chunk,
                           stream) == rc
    torch.cuda.synchronize()
