"""The PyTorch port's table images against the JAX package's.

Both packages write the same npz image (``repro/core/snapshot.py``): the
items of live buckets sorted by (full hash, key) under a versioned header.
Here, on the CPU:

* an image the port saves is read by the JAX ``load_image`` with equal
  arrays, and equals the image the JAX package saves for the same op
  stream, header included;
* a JAX-saved image restores into the port with equal content, and the
  port's re-save restores into the JAX package with equal content;
* images are layout-independent: different op histories and a restore
  into another geometry (a wide-lane spec included) re-save identically;
* the rejections (``check_restorable``), the version and magic errors and
  a torn save through the fault hook behave as in ``tests/test_snapshot.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snapshot as JS
from repro.core.invariants import to_dict as jax_to_dict
from repro.core.spec import TableSpec as JaxSpec
from repro.table_api import Table as JaxTable
from repro_torch.core import snapshot as S
from repro_torch.core import table as TT
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.spec import TableSpec
from repro_torch.table_api import Table

jax.config.update("jax_platform_name", "cpu")

GEOM = dict(dmax=9, bucket_size=4, pool_size=256, n_lanes=16)
WIDE = dict(dmax=10, bucket_size=8, pool_size=512, n_lanes=1100,
            initial_depth=4)


def op_stream(seed, m=6):
    rng = np.random.default_rng(seed)
    universe = np.arange(1, 3000)
    out = []
    for _ in range(m):
        k = int(rng.integers(20, 60))
        out.append((rng.integers(1, 3, size=k).astype(np.int32),
                    rng.choice(universe, size=k, replace=False).astype(
                        np.int32),
                    rng.integers(0, 999, size=k).astype(np.int32)))
    return out


def both_tables(geom, seed, backend="plain"):
    """The same op stream through a port table and a JAX table."""
    t = Table.create(TableSpec(**geom, backend=backend), device="cpu")
    jt = JaxTable.create(JaxSpec(**geom, backend="xla"))
    for kinds, keys, vals in op_stream(seed):
        t, _ = t.apply(kinds, keys, vals)
        jt, _ = jt.apply(kinds, keys, vals)
    return t, jt


def assert_same_image(a, b):
    assert a.header == b.header
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.values, b.values)
    assert a.keys.dtype == b.keys.dtype == np.int32
    assert a.values.dtype == b.values.dtype == np.int32


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_port_image_is_the_jax_image(tmp_path, backend):
    t, jt = both_tables(GEOM, 11, backend)
    path = t.save(str(tmp_path / "port.npz"))
    jpath = jt.save(str(tmp_path / "jax.npz"))
    read_by_jax = JS.load_image(path)
    assert_same_image(read_by_jax, JS.load_image(jpath))
    assert_same_image(S.load_image(path), read_by_jax)
    assert read_by_jax.n_items == len(to_dict(t.config, t.state)) > 0


def test_jax_image_restores_into_port_and_back(tmp_path):
    _, jt = both_tables(GEOM, 12)
    jpath = jt.save(str(tmp_path / "jax.npz"))
    want = jax_to_dict(jt.config, jt.state)
    for backend in ("plain", "cuda"):
        t = Table.restore(jpath, TableSpec(**GEOM, backend=backend),
                          device="cpu")
        assert to_dict(t.config, t.state) == want, backend
        check_invariants(t.config, t.state)
        path = t.save(str(tmp_path / f"port_{backend}.npz"))
        assert_same_image(S.load_image(path), JS.load_image(jpath))
        back = JaxTable.restore(path, JaxSpec(**GEOM, backend="xla"))
        assert jax_to_dict(back.config, back.state) == want, backend


def test_image_is_layout_independent(tmp_path):
    """Same content through different histories → identical images; a
    restore into another geometry re-saves to the same image."""
    rng = np.random.default_rng(5)
    keys = rng.choice(np.arange(1, 1 << 20), size=300,
                      replace=False).astype(np.int32)
    spec = TableSpec(dmax=9, bucket_size=8, pool_size=256, n_lanes=16)
    ta = Table.create(spec, device="cpu")
    ta, _ = ta.insert(keys[100:], keys[100:] * 3)
    tb = Table.create(spec, device="cpu")
    tb, _ = tb.insert(keys[::-1], keys[::-1] * 3)
    tb, _ = tb.delete(keys[:100])
    assert not bool(ta.state.error) and not bool(tb.state.error)
    ia, ib = S.extract_image(ta), S.extract_image(tb)
    assert_same_image(ia, ib)
    path = S.save_image(ia, str(tmp_path / "a.npz"))
    t2 = Table.restore(path, TableSpec(dmax=12, bucket_size=8,
                                       pool_size=128, n_lanes=32),
                       device="cpu")
    i2 = S.extract_image(t2)
    assert i2.header["saved_spec"]["dmax"] == 12
    np.testing.assert_array_equal(i2.keys, ia.keys)
    np.testing.assert_array_equal(i2.values, ia.values)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_restore_into_wide_lane_spec(tmp_path, backend):
    """A 16-lane table's image restored into a 1,100-lane spec (past the
    fused apply kernel: the ``cuda`` plan runs grouped_apply and probe)
    holds the same content, keeps taking writes and re-saves identically."""
    t, _ = both_tables(GEOM, 13)
    path = t.save(str(tmp_path / "t.npz"))
    want = to_dict(t.config, t.state)
    spec = TableSpec(**WIDE, backend=backend)
    assert spec.plan("cpu").fused_apply is False
    tw = Table.restore(path, spec, device="cpu")
    assert to_dict(tw.config, tw.state) == want
    check_invariants(tw.config, tw.state)
    assert tw.seq == 1                        # one 1,100-lane transaction
    i1, i2 = S.load_image(path), S.extract_image(tw)
    np.testing.assert_array_equal(i1.keys, i2.keys)
    np.testing.assert_array_equal(i1.values, i2.values)
    q = np.fromiter(want, np.int32)
    found, vals = tw.lookup(q)
    assert bool(found.all()) and vals.tolist() == [want[k] for k in q]
    tw, res = tw.insert(np.arange(5000, 5300, dtype=np.int32))
    assert bool((res.status == 1).all()) and not bool(res.error)


def test_empty_and_frozen_tables(tmp_path):
    """An empty image restores anywhere; a mid-freeze table images like
    its unfrozen twin and restores unfrozen."""
    t = Table.create(TableSpec(**GEOM), device="cpu")
    path = t.save(str(tmp_path / "empty.npz"))
    t2 = Table.restore(path, TableSpec(dmax=5, pool_size=32, n_lanes=16),
                       device="cpu")
    assert int(t2.size()) == 0
    check_invariants(t2.config, t2.state)

    spec = TableSpec(dmax=6, bucket_size=4, pool_size=64, n_lanes=16,
                     hash_name="identity")
    keys = ((np.arange(8, dtype=np.uint32) << 28)).astype(np.int32)[1:]
    t = Table.create(spec, device="cpu")
    t, _ = t.insert(keys, keys * 3)
    t, _ = t.delete(keys[3:6])
    plain_image = S.extract_image(t)
    snap = TT.to_numpy(t.state)
    bid = int(np.argmax(np.where(snap["live"], snap["bdepth"], -1)))
    depth = int(snap["bdepth"][bid])
    st, ok = TT.freeze_buddies(t.config, t.state,
                               int(snap["bprefix"][bid]) >> 1, depth - 1)
    assert bool(ok) and bool(st.frozen.any())
    frozen_t = t._replace(state=st)
    assert_same_image(S.extract_image(frozen_t), plain_image)
    t3 = Table.restore(frozen_t.save(str(tmp_path / "f.npz")), spec,
                       device="cpu")
    assert not bool(t3.state.frozen.any())
    assert int(t3.size()) == plain_image.n_items == 4


def test_policy_counts_come_from_the_header(tmp_path):
    t, _ = both_tables(GEOM, 14)
    image = S.extract_image(t)
    assert image.header["policy_counts"] == [0, 0]
    image.header["policy_counts"] = [3, 1]
    path = S.save_image(image, str(tmp_path / "p.npz"))
    t2 = Table.restore(path, TableSpec(**GEOM), device="cpu")
    assert t2.state.policy_counts.tolist() == [3, 1]
    assert S.extract_image(t2).header["policy_counts"] == [3, 1]


def test_restore_rejections_are_clear(tmp_path):
    # (a) dmax too shallow: 6 identity-hash keys share the top 4 bits
    ti = Table.create(TableSpec(dmax=8, bucket_size=4, pool_size=64,
                                n_lanes=16, hash_name="identity"),
                      device="cpu")
    kk = ((np.uint32(0xA) << 28)
          | (np.arange(6, dtype=np.uint32) << 22)).astype(np.int32)
    ti, res = ti.insert(kk, kk)
    assert not bool(res.error)
    path = ti.save(str(tmp_path / "i.npz"))
    with pytest.raises(ValueError, match="too shallow.*need dmax >= 8"):
        Table.restore(path, TableSpec(dmax=4, bucket_size=4, pool_size=64,
                                      n_lanes=16, hash_name="identity"),
                      device="cpu")
    # the JAX package rejects the same target with the same message
    with pytest.raises(ValueError, match="too shallow.*need dmax >= 8"):
        JaxTable.restore(path, JaxSpec(dmax=4, bucket_size=4, pool_size=64,
                                       n_lanes=16, hash_name="identity"))

    # (b) more items than the pool's slots
    with pytest.raises(ValueError, match="too small"):
        Table.restore(path, TableSpec(dmax=8, bucket_size=4, pool_size=1,
                                      n_lanes=16, hash_name="identity"),
                      device="cpu")

    # (c) a value-schema image (saved by the JAX package) into the port
    jspec = JaxSpec(dmax=10, pool_size=256, n_lanes=16,
                    value_schema={"page": jnp.int32})
    jt = JaxTable.create(jspec)
    jt, _ = jt.insert(np.arange(1, 21, dtype=np.int32),
                      {"page": np.arange(1, 21, dtype=np.int32)})
    spath = jt.save(str(tmp_path / "s.npz"))
    with pytest.raises(ValueError, match="value schema mismatch"):
        Table.restore(spath, TableSpec(dmax=10, pool_size=256, n_lanes=16),
                      device="cpu")
    with pytest.raises(ValueError, match="value schema mismatch"):
        JaxTable.restore(spath, JaxSpec(dmax=10, pool_size=256, n_lanes=16))


def test_versioned_header(tmp_path):
    """Future-version images fail with a clear error; corrupt magic and a
    file without a header too — in both packages' readers."""
    t, _ = both_tables(GEOM, 15)
    img = S.extract_image(t)
    assert img.header["version"] == S.FORMAT_VERSION == JS.FORMAT_VERSION
    assert img.header["format"] == S.FORMAT_MAGIC == JS.FORMAT_MAGIC

    img.header["version"] = S.FORMAT_VERSION + 1
    path = S.save_image(img, str(tmp_path / "future.npz"))
    for load in (S.load_image, JS.load_image):
        with pytest.raises(ValueError, match="newer than this reader"):
            load(path)

    img.header["version"] = S.FORMAT_VERSION
    img.header["format"] = "something-else"
    path = S.save_image(img, str(tmp_path / "magic.npz"))
    for load in (S.load_image, JS.load_image):
        with pytest.raises(ValueError, match="bad magic"):
            load(path)

    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, a=np.arange(3))
    with pytest.raises(ValueError, match="missing header"):
        S.load_image(bogus)


def test_torn_save_keeps_the_previous_image(tmp_path):
    """A crash before the atomic rename (the fault hook) leaves the tmp
    file behind and the destination's previous image intact."""
    t, _ = both_tables(GEOM, 16)
    path = t.save(str(tmp_path / "t.npz"))
    before = S.load_image(path)
    t, _ = t.insert(np.arange(9000, 9040, dtype=np.int32))

    def crash(point, _path):
        if point == "pre_rename":
            raise S.InjectedFault("torn save")

    prev = S.set_fault_hook(crash)
    try:
        with pytest.raises(S.InjectedFault):
            t.save(path)
    finally:
        assert S.set_fault_hook(prev) is crash
    assert (tmp_path / "t.npz.tmp").exists()
    assert_same_image(S.load_image(path), before)
    t.save(path)
    assert S.load_image(path).n_items == before.n_items + 40


def test_restore_without_device_needs_cuda(tmp_path):
    """Restore is an entry point: it defaults to the card and never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    t = Table.create(TableSpec(**GEOM), device="cpu")
    path = t.save(str(tmp_path / "t.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Table.restore(path, TableSpec(**GEOM))
