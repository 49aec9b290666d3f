"""The port's oracles against each other and against the JAX package's.

The tier-1 cases of ``tests/test_oracle.py`` on the port's copy of
``core/reference.py`` and its snapshot images: the streaming oracle equals
the materializing one (statuses, reads and content) on randomized streams
in tiny geometries where OVERFLOW and splits dominate, and both equal the
JAX package's streaming oracle op for op; the digest algebra (and the
digests equal the JAX package's); the canonical image is invariant under
insert order and equals the JAX package's image; the replayer's oracle
modes; and the 200k-op streaming burst.
"""
import numpy as np
import pytest

from _hyp import given, settings, st
from repro.core import reference as JR
from repro.core import snapshot as JS
from repro.table_api import Table as JaxTable
from repro.table_api import TableSpec as JaxSpec
from repro_torch.core import reference as R
from repro_torch.core import snapshot as S
from repro_torch.table_api import Table, TableSpec

_MASK64 = (1 << 64) - 1


def _oracles(dmax, bucket_size):
    return (R.SeqExtHash(dmax, bucket_size), R.StreamingOracle(dmax,
                                                                bucket_size),
            JR.StreamingOracle(dmax, bucket_size))


@given(st.data())
@settings(max_examples=40, deadline=None)
def test_streaming_equals_materializing(data):
    """Lock-step status/read/content parity on randomized op streams in
    small geometries (dmax 2..6, bucket_size 1..4) over a narrow key range:
    duplicate upserts, deletes of absent keys, saturated hash-prefix groups
    (OVERFLOW on the insert and delete paths), negative keys."""
    dmax = data.draw(st.integers(2, 6))
    b = data.draw(st.integers(1, 4))
    n_ops = data.draw(st.integers(1, 200))
    span = data.draw(st.integers(8, 96))
    mat, stream, jax_stream = _oracles(dmax, b)

    for _ in range(n_ops):
        op = data.draw(st.sampled_from(("ins", "del", "get")))
        key = data.draw(st.integers(-span, span))
        if op == "ins":
            val = data.draw(st.integers(0, (1 << 20)))
            got = [o.insert(key, val) for o in (mat, stream, jax_stream)]
        elif op == "del":
            got = [o.delete(key) for o in (mat, stream, jax_stream)]
        else:
            got = [o.lookup(key) for o in (mat, stream, jax_stream)]
        assert got[0] == got[1] == got[2], (op, key, got)

    assert mat.as_dict() == stream.as_dict() == jax_stream.as_dict()
    assert stream.size == len(stream.as_dict())
    # the rolling digest equals a from-scratch digest of the final content
    items = sorted(stream.as_dict().items())
    keys = np.array([k for k, _ in items], dtype=np.int64)
    vals = np.array([v for _, v in items], dtype=np.int64)
    assert stream.digest == R.content_digest(keys, vals) == jax_stream.digest


def test_overflow_regime_reachable():
    """The property test's geometry reaches OVERFLOW, on the insert and on
    the delete path (bucket_size 1 at dmax 2 saturates quickly)."""
    mat, stream, _ = _oracles(2, 1)
    statuses = [(mat.insert(k, k), stream.insert(k, k)) for k in range(64)]
    assert all(m == s for m, s in statuses)
    assert any(m == R.OVERFLOW for m, _ in statuses)
    deletes = [(mat.delete(k), stream.delete(k)) for k in range(64, 160)]
    assert all(m == s for m, s in deletes)
    assert any(m == R.OVERFLOW for m, _ in deletes)


def test_digest_algebra():
    """content_digest is the commutative sum of pair_digest terms: order
    cannot matter and removal is exact subtraction; both equal the JAX
    package's."""
    rng = np.random.default_rng(7)
    keys = rng.integers(-(1 << 31), 1 << 31, 64).astype(np.int64)
    vals = rng.integers(0, 1 << 31, 64).astype(np.int64)
    want = 0
    for k, v in zip(keys, vals):
        term = R.pair_digest(int(k), int(v))
        assert term == JR.pair_digest(int(k), int(v))
        want = (want + term) & _MASK64
    assert R.content_digest(keys, vals) == want
    assert JR.content_digest(keys, vals) == want
    perm = rng.permutation(64)
    assert R.content_digest(keys[perm], vals[perm]) == want
    drop = (want - R.pair_digest(int(keys[0]), int(vals[0]))) & _MASK64
    assert R.content_digest(keys[1:], vals[1:]) == drop
    empty = np.array([], dtype=np.int64)
    assert R.content_digest(empty, empty) == 0


@given(st.data())
@settings(max_examples=6, deadline=None)
def test_snapshot_canonical_image_order_invariant(data):
    """Two tables holding the same items give identical images whatever
    the insert order, and the image is the JAX package's: the property
    the chaos harness's digest check rests on."""
    keys = data.draw(st.lists(st.integers(0, 4000),
                              min_size=1, max_size=40, unique=True))
    geom = dict(dmax=8, bucket_size=8, pool_size=128, n_lanes=16)

    def build(order):
        t = Table.create(TableSpec(**geom), device="cpu")
        arr = np.asarray(order, dtype=np.int32)
        t, _ = t.apply(np.ones_like(arr), arr, arr * 3 + 1)
        return S.extract_image(t)

    fwd = build(keys)
    rev = build(list(reversed(keys)))
    assert fwd.n_items == rev.n_items == len(keys)
    np.testing.assert_array_equal(fwd.keys, rev.keys)
    np.testing.assert_array_equal(fwd.values, rev.values)
    jt = JaxTable.create(JaxSpec(**geom, backend="xla"))
    arr = np.asarray(keys, dtype=np.int32)
    jt, _ = jt.apply(np.ones_like(arr), arr, arr * 3 + 1)
    jimage = JS.extract_image(jt)
    np.testing.assert_array_equal(fwd.keys, jimage.keys)
    np.testing.assert_array_equal(fwd.values, jimage.values)
    assert (R.content_digest(fwd.keys, fwd.values)
            == R.content_digest(rev.keys, rev.values)
            == JR.content_digest(jimage.keys, jimage.values))


@pytest.mark.parametrize("oracle", ["streaming", "both"])
def test_replay_oracle_modes(oracle):
    """The replayer's oracle selection on a churny registry scenario."""
    from repro_torch.workloads import get_scenario, replay

    spec, trace = get_scenario("mixed_churn", scale=0.4)
    rep = replay(spec, trace, device="cpu", oracle=oracle,
                 raise_on_mismatch=False)
    assert rep["ok"], (rep["status_mismatches"], rep["content_mismatches"],
                       rep["mismatch_examples"], rep["error_flag"])
    assert rep["oracle"] == oracle
    assert rep["policy"]["splits"] > 0


def test_streaming_oracle_million_op_burst():
    """200k ops through the streaming oracle, its rolling digest equal to
    a from-scratch digest of the final content."""
    stream = R.StreamingOracle(18, 8)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 20, 200_000)
    for i, k in enumerate(keys.tolist()):
        if i % 3 == 2:
            stream.delete(k)
        else:
            stream.insert(k, i)
    assert stream.size > 0
    items = sorted(stream.as_dict().items())
    ks = np.array([k for k, _ in items], dtype=np.int64)
    vs = np.array([v for _, v in items], dtype=np.int64)
    assert stream.digest == R.content_digest(ks, vs)
