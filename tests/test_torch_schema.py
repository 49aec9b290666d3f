"""The PyTorch port's value schemas against the JAX package's.

The same seeded batches go through a ``repro_torch`` table with a value
schema (both plans, on the CPU) and a ``repro.table_api.Table`` with the
same schema (``backend="xla"``): statuses, looked-up payloads, ``size`` and
every state array — the value words, which hold the payload handles,
included — must be equal after every call, the trash rows excepted; so
must the slabs and their liveness bitmap. Under the ``cuda`` plan (the
kernels' plain versions on CPU tensors) pool rows are compared as sets:
the lane-order kernel may put a fresh insert in another free slot.

Key streams keep ``INT32_MIN`` out (the two packages' lookups disagree on
it); ``test_empty_key_insert_leaves_payloads_alone`` pins the port's
behaviour instead. The ``cuda`` plan on the card is held against the
``plain`` plan in ``test_torch_cuda_paths.py``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snapshot as JS
from repro.core import table as JT
from repro.table_api import Table as JaxTable
from repro.table_api import TableSpec as JaxSpec
from repro_torch.core import snapshot as S
from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.table_api import Table, TableSpec, from_numpy_state, to_numpy

jax.config.update("jax_platform_name", "cpu")

GEOM = dict(dmax=8, bucket_size=4, pool_size=256, n_lanes=16)
# the facade acceptance schema of tests/test_table_api.py: two leaves, mixed
# dtypes, one non-scalar field (declared with torch and numpy dtypes here)
SCHEMA = {"page": torch.int32, "score": (np.float32, (2,))}
JAX_SCHEMA = {"page": jnp.int32, "score": (jnp.float32, (2,))}


def tables(geom=GEOM, backend="plain", **kw):
    t = Table.create(TableSpec(**geom, backend=backend, value_schema=SCHEMA,
                               **kw), device="cpu")
    jt = JaxTable.create(JaxSpec(**geom, backend="xla",
                                 value_schema=JAX_SCHEMA, **kw))
    return t, jt


def payload(keys):
    keys = np.asarray(keys)
    return {"page": (keys * 5).astype(np.int32),
            "score": np.stack([keys / 3, keys / 7], -1).astype(np.float32)}


def assert_same_tables(t, jt, rows_as_sets=False, where=""):
    """Every state array, the slabs and the liveness bitmap equal, the
    trash rows excepted (pool rows as sets under ``rows_as_sets``)."""
    P, cap = t.spec.pool_size, t.spec.slab_rows
    a = to_numpy(t.state)
    for f, x in a.items():
        y = np.asarray(getattr(jt.state, f))
        if x.ndim and x.shape[0] == P + 1:
            x, y = x[:P], y[:P]
        if rows_as_sets and f in ("keys", "vals"):
            x = np.take_along_axis(x, np.argsort(a["keys"][:P], 1), 1)
            jk = np.asarray(jt.state.keys)[:P]
            y = np.take_along_axis(y, np.argsort(jk, 1), 1)
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: {f}")
    for name, slab in t.slabs.items():
        np.testing.assert_array_equal(slab[:cap].numpy(),
                                      np.asarray(jt.slabs[name])[:cap],
                                      err_msg=f"{where}: slab {name}")
    np.testing.assert_array_equal(t.slab_live.numpy(),
                                  np.asarray(jt.slab_live),
                                  err_msg=f"{where}: slab_live")


def assert_same_lookup(t, jt, q, where=""):
    found, val = t.lookup(q)
    jfound, jval = jt.lookup(np.asarray(q, np.int32))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound),
                                  err_msg=where)
    assert sorted(val) == sorted(jval)
    for name in val:
        np.testing.assert_array_equal(val[name].numpy(),
                                      np.asarray(jval[name]),
                                      err_msg=f"{where}: {name}")


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_schema_facade_matches_jax(backend):
    """The facade body of tests/test_table_api.py, step by step on both
    packages, then seeded 37-op mixed batches with duplicate keys."""
    t, jt = tables(backend=backend)
    sets = backend == "cuda"
    rng = np.random.default_rng(11)
    keys = rng.choice(np.arange(1, 10_000), size=37,
                      replace=False).astype(np.int32)

    def both(method, *args):
        nonlocal t, jt
        t, res = getattr(t, method)(*args)
        jt, jres = getattr(jt, method)(*args)
        np.testing.assert_array_equal(res.status.numpy(),
                                      np.asarray(jres.status), err_msg=method)
        assert bool(res.error) == bool(jres.error)
        assert int(t.size()) == int(jt.size())
        assert_same_tables(t, jt, sets, method)
        return res.status.numpy()

    assert (both("insert", keys, payload(keys)) == 1).all()
    assert int(t.size()) == 37
    probe = np.r_[keys[:5], [9999, 8888]].astype(np.int32)
    assert_same_lookup(t, jt, probe, "lookup")
    found, val = t.lookup(probe)
    assert found.tolist() == [True] * 5 + [False] * 2
    assert (val["page"][5:] == 0).all() and (val["score"][5:] == 0).all()
    assert (both("insert", keys[:9], {"page": np.full(9, 7, np.int32),
                                      "score": np.zeros((9, 2), np.float32)})
            == 0).all()
    assert_same_lookup(t, jt, keys[:10], "upserted")
    assert (both("update", np.r_[keys[9:12], [4242]].astype(np.int32),
                 payload(np.r_[keys[9:12] + 1, [1]])) == [0, 0, 0, 0]).all()
    assert (both("delete", keys[:13]) == 1).all()
    assert int(t.size()) == 24 and int(t.slab_live.sum()) == 24 + 1
    assert (both("delete", keys[:4]) == 0).all()

    universe = np.r_[keys, rng.integers(1, 400, size=40)].astype(np.int32)
    for rnd in range(6):
        kinds = rng.integers(0, 3, size=37).astype(np.int32)
        ks = rng.choice(universe, size=37).astype(np.int32)
        both("apply", kinds, ks, payload(ks + rnd))
        assert_same_lookup(t, jt, np.r_[universe, [77777]], f"round {rnd}")
        assert int(t.slab_live.sum()) == int(t.size()) + 1
    check_invariants(t.config, t.state)


def test_intra_batch_insert_delete_races():
    """One batch holding inserts, upserts and deletes of the same few keys
    in every order: handles, payloads (last applied writer) and liveness
    equal the JAX package's after every transaction."""
    t, jt = tables()
    rng = np.random.default_rng(5)
    hot = np.array([3, 8, 21, 55, 89, 144], np.int32)
    for rnd in range(8):
        kinds = rng.integers(1, 3, size=16).astype(np.int32)
        ks = rng.choice(hot, size=16).astype(np.int32)
        vals = payload(ks * 10 + rnd)
        vals["page"] = np.arange(16, dtype=np.int32) + 100 * rnd
        t, res = t.apply(kinds, ks, vals)
        jt, jres = jt.apply(kinds, ks, vals)
        np.testing.assert_array_equal(res.status.numpy(),
                                      np.asarray(jres.status))
        assert_same_tables(t, jt, where=f"round {rnd}")
        assert_same_lookup(t, jt, hot, f"round {rnd}")
        assert int(t.slab_live.sum()) == int(t.size()) + 1
        # a key inserted here holds the payload of its last insert lane
        found, val = t.lookup(hot)
        for k, f, page in zip(hot, found.tolist(), val["page"].tolist()):
            lanes = np.nonzero(ks == k)[0]
            if f and lanes.size and kinds[lanes[-1]] == 1:
                assert page == vals["page"][lanes[-1]]


def test_frozen_upsert_preserves_payload():
    """A FROZEN (not executed) upsert leaves the key's payload alone, as in
    tests/test_table_api.py::test_frozen_upsert_preserves_payload."""
    geom = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8,
                initial_depth=1)
    t = Table.create(TableSpec(**geom, value_schema={"v": "int32"}),
                     device="cpu")
    jt = JaxTable.create(JaxSpec(**geom, backend="xla",
                                 value_schema={"v": jnp.int32}))
    t, res = t.insert([5], {"v": [111]})
    jt, _ = jt.insert([5], {"v": [111]})
    assert res.status.tolist() == [1]
    st, ok = T.freeze_buddies(t.config, t.state, 0, 0)
    jst, jok = JT.freeze_buddies(jt.config, jt.state, 0, 0)
    assert bool(ok) and bool(jok)
    t, jt = t._replace(state=st), jt._replace(state=jst)
    t, res = t.insert([5], {"v": [222]})
    jt, jres = jt.insert([5], {"v": [222]})
    assert res.status.tolist() == np.asarray(jres.status).tolist() == [
        T.FROZEN]
    found, val = t.lookup([5])
    assert found.tolist() == [True] and val["v"].tolist() == [111]
    assert_same_tables(t, jt)


def test_schema_empty_and_single_batches():
    t, jt = tables(dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8))
    empty = np.zeros(0, np.int32)
    found, vals = t.lookup(empty)
    assert found.shape == (0,)
    assert vals["page"].shape == (0,) and vals["score"].shape == (0, 2)
    assert vals["score"].dtype == torch.float32
    t2, res = t.apply(empty, empty, {"page": empty,
                                     "score": np.zeros((0, 2), np.float32)})
    assert t2 is t and res.status.shape == (0,) and t.seq == 0
    t2, res = t.insert(empty, None)
    assert t2 is t and res.status.shape == (0,)
    one = np.array([42], np.int32)
    t, res = t.insert(one, payload(one))
    jt, _ = jt.insert(one, payload(one))
    assert res.status.tolist() == [1] and t.seq == 1
    assert_same_lookup(t, jt, one)
    assert_same_tables(t, jt)
    t, res = t.delete(one)
    jt, _ = jt.delete(one)
    assert res.status.tolist() == [1] and int(t.size()) == 0
    assert int(t.slab_live.sum()) == 1
    assert_same_tables(t, jt)


def test_schema_values_are_validated():
    t, _ = tables()
    keys = np.array([1, 2], np.int32)
    with pytest.raises(ValueError, match="schema fields"):
        t.insert(keys, {"page": keys})
    with pytest.raises(ValueError, match="score"):
        t.insert(keys, {"page": keys, "score": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="slab_capacity"):
        TableSpec(**GEOM, slab_capacity=8)
    spec = TableSpec(**GEOM, value_schema=SCHEMA)
    assert spec.value_schema == JaxSpec(**GEOM,
                                        value_schema=JAX_SCHEMA).value_schema
    assert spec.slab_rows == 256 * 4
    assert spec.field_dtypes() == {"page": torch.int32,
                                   "score": torch.float32}


def test_slab_exhaustion_sets_error():
    """More new keys than slab rows: both packages set the error flag, hand
    out the same handles (the overflowing keys get the trash row) and
    agree on every state array."""
    t, jt = tables(slab_capacity=8)
    keys = np.arange(1, 13, dtype=np.int32)
    t, res = t.insert(keys, payload(keys))
    jt, jres = jt.insert(keys, payload(keys))
    np.testing.assert_array_equal(res.status.numpy(),
                                  np.asarray(jres.status))
    assert bool(res.error) and bool(jres.error)
    assert_same_tables(t, jt)
    assert int(t.slab_live.sum()) == 8 + 1


def test_empty_key_insert_leaves_payloads_alone():
    """An ``INT32_MIN`` insert: the port's lookups never find the sentinel,
    so the insert takes a fresh handle, reports FALSE (the sentinel
    "exists" in a free slot, as in the raw write path), and leaves size,
    liveness and every other key's payload unchanged. The JAX package's
    lookup matches the sentinel to a free slot and writes its payload
    through that slot's value word instead (ROADMAP §3)."""
    t, _ = tables()
    keys = np.arange(1, 20, dtype=np.int32)
    t, _ = t.insert(keys, payload(keys))
    live0 = t.slab_live.clone()
    pages0 = t.slabs["page"].clone()
    empty = np.array([-2**31], np.int32)
    t, res = t.insert(empty, payload([1]))
    assert res.status.tolist() == [T.FALSE]
    found, _ = t.lookup(empty)
    assert found.tolist() == [False]
    assert int(t.size()) == 19
    assert torch.equal(t.slab_live, live0)
    live = live0.nonzero()[:, 0]
    assert torch.equal(t.slabs["page"][live], pages0[live])
    found, val = t.lookup(keys)
    assert found.all() and val["page"].tolist() == (keys * 5).tolist()


def test_schema_images_cross_both_ways(tmp_path):
    """A port schema image is the JAX image for the same op stream; it
    restores into the JAX package, and a JAX image restores into the port
    (at another geometry, lane width and slab capacity), with equal
    payloads; raw and schema specs refuse each other's images."""
    t, jt = tables()
    rng = np.random.default_rng(3)
    universe = rng.choice(np.arange(1, 5000), size=200,
                          replace=False).astype(np.int32)
    for rnd in range(5):
        kinds = rng.integers(1, 3, size=37).astype(np.int32)
        kinds[: 30 - 5 * rnd] = 1
        ks = rng.choice(universe, size=37).astype(np.int32)
        t, _ = t.apply(kinds, ks, payload(ks + rnd))
        jt, _ = jt.apply(kinds, ks, payload(ks + rnd))
    path = t.save(str(tmp_path / "port.npz"))
    jpath = jt.save(str(tmp_path / "jax.npz"))
    mine, theirs = JS.load_image(path), JS.load_image(jpath)
    assert mine.header == theirs.header
    assert mine.header["value_schema"] == [["page", "int32", []],
                                           ["score", "float32", [2]]]
    np.testing.assert_array_equal(mine.keys, theirs.keys)
    for name in ("page", "score"):
        np.testing.assert_array_equal(mine.values[name], theirs.values[name])
        assert mine.values[name].dtype == theirs.values[name].dtype
    assert mine.n_items == len(to_dict(t.config, t.state)) > 0

    other = dict(dmax=9, bucket_size=8, pool_size=128, n_lanes=40)
    jback = JaxTable.restore(path, JaxSpec(**other, backend="xla",
                                           value_schema=JAX_SCHEMA,
                                           slab_capacity=600))
    back = Table.restore(jpath, TableSpec(**other, value_schema=SCHEMA,
                                          slab_capacity=600), device="cpu")
    q = np.r_[universe, [9999]].astype(np.int32)
    assert_same_lookup(back, jt, q, "port restore of the JAX image")
    assert_same_lookup(t, jback, q, "JAX restore of the port image")
    assert int(back.slab_live.sum()) == mine.n_items + 1
    check_invariants(back.config, back.state)

    raw = Table.create(TableSpec(**GEOM), device="cpu")
    raw, _ = raw.insert([1, 2, 3], [4, 5, 6])
    raw_path = raw.save(str(tmp_path / "raw.npz"))
    with pytest.raises(ValueError, match="value schema mismatch"):
        Table.restore(path, TableSpec(**GEOM), device="cpu")
    with pytest.raises(ValueError, match="value schema mismatch"):
        Table.restore(raw_path, TableSpec(**GEOM, value_schema=SCHEMA),
                      device="cpu")
    with pytest.raises(ValueError, match="value schema mismatch"):
        Table.restore(path, TableSpec(**GEOM, value_schema={"page": "int32"}),
                      device="cpu")
    with pytest.raises(ValueError, match="slab store too small"):
        S.check_restorable(S.load_image(path), TableSpec(
            **GEOM, value_schema=SCHEMA, slab_capacity=mine.n_items - 1))


def test_state_with_slabs_carries_across():
    """A JAX schema table's state, slabs and bitmap carried into the port
    (``from_numpy_state`` and ``Table.from_state``) keep answering and
    writing as the JAX table does."""
    _, jt = tables()
    keys = np.arange(1, 60, dtype=np.int32)
    jt, _ = jt.insert(keys, payload(keys))
    jt, _ = jt.delete(keys[::3])
    t = Table.from_state(
        TableSpec(**GEOM, value_schema=SCHEMA),
        from_numpy_state({f: np.asarray(getattr(jt.state, f))
                          for f in jt.state._fields}, "cpu"),
        seq=int(jt.seq),
        slabs={k: torch.from_numpy(np.array(v)) for k, v in jt.slabs.items()},
        slab_live=torch.from_numpy(np.array(jt.slab_live)))
    assert_same_tables(t, jt)
    more = np.arange(50, 90, dtype=np.int32)
    t, res = t.insert(more, payload(more * 2))
    jt, jres = jt.insert(more, payload(more * 2))
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert_same_tables(t, jt)
    assert_same_lookup(t, jt, np.arange(1, 95, dtype=np.int32))


# ---------------------------------------------------------------------------
# every dtype the JAX spec takes

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64", "float16", "float32", "float64", "bool", "bfloat16"]


def typed(dtype, keys):
    """Seeded values of ``dtype`` for ``keys`` as a numpy array (``bfloat16``
    through ``ml_dtypes``), each field's unsigned range exercised; 64-bit
    values stay inside the 32 bits the JAX package keeps with x64 off."""
    k = np.asarray(keys, np.int64)
    if dtype == "bool":
        return k % 3 == 0
    if dtype.startswith("float") or dtype == "bfloat16":
        # multiples of 1/4 below 64: exact in every float type
        return ((k % 256) / 4).astype(jnp.dtype(dtype))
    if dtype.startswith("uint"):
        top = 1 << (min(np.iinfo(dtype).bits, 32) - 1)
        return ((k % 1000) + top).astype(dtype)
    info = np.iinfo(dtype)
    return ((k % (min(info.max, 1 << 20))) - min(info.max, 1 << 19) // 2
            ).astype(dtype)


def to_bits(x):
    """A payload (torch tensor, JAX array or numpy array, image ``V2`` words
    included) as a numpy array comparable across packages: ``bfloat16`` as
    its 16-bit words."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iuf":
        return x.view(np.int16)          # ml_dtypes.bfloat16 or V2 words
    return x


def port_values(schema, vals):
    """The JAX-side numpy payloads as the port's tensors (``bfloat16``
    bit-cast, since numpy has no ``bfloat16`` that torch reads)."""
    out = {}
    for f in schema:
        v = vals[f.name]
        if f.dtype == "bfloat16":
            out[f.name] = torch.from_numpy(
                np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
        else:
            out[f.name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


DTYPE_GEOM = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8)


def dtype_schemas(dtype):
    """(port schema, JAX schema): one scalar and one ``(2,)`` field."""
    return ({"v": dtype, "w": (dtype, (2,))},
            {"v": jnp.dtype(dtype), "w": (jnp.dtype(dtype), (2,))})


def dtype_values(dtype, keys):
    w = np.stack([typed(dtype, keys), typed(dtype, np.asarray(keys) + 7)],
                 -1)
    return {"v": typed(dtype, keys), "w": w}


def dtype_stream(dtype):
    """The insert, upsert, delete and mixed batches of ``dtype``'s case as
    (kinds, keys, the keys its values are drawn from), and its queries:
    every batch 24 ops and every lookup 96 keys, one compiled shape each."""
    rng = np.random.default_rng(DTYPES.index(dtype))
    keys = rng.choice(np.arange(1, 4000), size=48,
                      replace=False).astype(np.int32)
    ones = np.ones(24, np.int32)
    batches = [(ones, keys[:24], keys[:24]),                  # insert
               (ones, keys[24:], keys[24:]),
               (ones, keys[:24], keys[:24] + 5),              # upsert
               (2 * ones, keys[12:36], keys[12:36])]          # delete
    for _ in range(3):
        kinds = rng.integers(0, 3, size=24).astype(np.int32)
        ks = rng.choice(np.r_[keys, keys + 4001], size=24).astype(np.int32)
        batches.append((kinds, ks, ks + 1))
    return batches, np.r_[keys, keys + 4001].astype(np.int32)


def port_dtype_table(dtype):
    """``dtype``'s stream through the port (CPU): (table, statuses)."""
    port_schema, _ = dtype_schemas(dtype)
    spec = TableSpec(**DTYPE_GEOM, backend="plain", value_schema=port_schema)
    t = Table.create(spec, device="cpu")
    statuses = []
    for kinds, keys, vkeys in dtype_stream(dtype)[0]:
        t, res = t.apply(kinds, keys, port_values(
            spec.value_schema, dtype_values(dtype, vkeys)))
        statuses.append(res.status.numpy())
    return t, statuses


def _jax_dtypes(port_dir, out_path):
    """The JAX half of ``test_every_dtype_matches_jax`` for every dtype,
    in one process: the JAX facade's (``backend="xla"``) statuses,
    lookups, slabs, saved image file and in-memory image, and its restore
    of the port's image file of the same stream."""
    import json
    out = {}
    for dtype in DTYPES:
        _, jax_schema = dtype_schemas(dtype)
        jspec = JaxSpec(**DTYPE_GEOM, backend="xla", value_schema=jax_schema)
        out[f"{dtype}|schema"] = np.frombuffer(json.dumps(
            [[f[0], f[1], list(f[2])] for f in jspec.value_schema]).encode(),
            np.uint8)
        jt = JaxTable.create(jspec)
        batches, q = dtype_stream(dtype)
        for i, (kinds, keys, vkeys) in enumerate(batches):
            jt, jres = jt.apply(kinds, keys, dtype_values(dtype, vkeys))
            out[f"{dtype}|status{i}"] = np.asarray(jres.status)
        jfound, jgot = jt.lookup(q)
        out[f"{dtype}|got_found"] = np.asarray(jfound)
        cap = jspec.slab_rows
        for name in ("v", "w"):
            out[f"{dtype}|got_{name}"] = to_bits(jgot[name])
            out[f"{dtype}|slab_{name}"] = to_bits(
                np.asarray(jt.slabs[name])[:cap])
        jt.save(os.path.join(port_dir, f"jax_{dtype}.npz"))
        image = JS.extract_image(jt)
        out[f"{dtype}|mem_header"] = np.frombuffer(
            json.dumps(image.header, default=lambda o: o.item()).encode(),
            np.uint8)
        out[f"{dtype}|mem_keys"] = image.keys
        for name in ("v", "w"):
            out[f"{dtype}|mem_{name}"] = to_bits(image.values[name])
        # the JAX package restores the port's file; its reader leaves a
        # bfloat16 field as raw V2 words, which its restore cannot take,
        # so they are viewed as ml_dtypes.bfloat16 first (ROADMAP §3)
        image = JS.load_image(os.path.join(port_dir, f"port_{dtype}.npz"))
        if dtype == "bfloat16":
            image.values = {k: v.view(jnp.bfloat16)
                            for k, v in image.values.items()}
        jfound, jgot = JS.restore_from_image(image, jspec).lookup(q)
        out[f"{dtype}|back_found"] = np.asarray(jfound)
        for name in ("v", "w"):
            out[f"{dtype}|back_{name}"] = to_bits(jgot[name])
    np.savez(out_path, **out)
    return 0


def _make_jax_dtypes(path):
    """The port's image file of every dtype's stream, then the JAX half
    in a fresh process (XLA's CPU compiler has crashed in test workers that
    had compiled many programs)."""
    import subprocess
    import sys
    os.makedirs(path + ".part", exist_ok=True)
    for dtype in DTYPES:
        t, _ = port_dtype_table(dtype)
        t.save(os.path.join(path + ".part", f"port_{dtype}.npz"))
    here = os.path.abspath(__file__)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(here), "..", "src"))
    proc = subprocess.run(
        [sys.executable, here, "--jax-dtypes", path + ".part",
         os.path.join(path + ".part", "jax.npz")],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    os.replace(path + ".part", path)


@pytest.fixture(scope="module")
def jax_dtypes(tmp_path_factory):
    """(the JAX half's arrays, the directory of both packages' files),
    made once per test session."""
    from test_torch_dist import session_path
    path = session_path(tmp_path_factory, "jax_dtypes", _make_jax_dtypes)
    with np.load(os.path.join(path, "jax.npz")) as z:
        return dict(z), path


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_matches_jax(dtype, tmp_path, jax_dtypes):
    """One scalar and one ``(2,)`` field of ``dtype``: the same insert,
    upsert, delete and mixed batches through the JAX facade
    (``backend="xla"``) and the port (CPU) give equal statuses, payloads,
    slabs and images, and each package restores the other's image. The
    JAX half runs for every dtype in one subprocess (``_jax_dtypes``)."""
    import json
    J, files = jax_dtypes
    port_schema, _ = dtype_schemas(dtype)
    spec = TableSpec(**DTYPE_GEOM, backend="plain", value_schema=port_schema)
    assert [[f.name, f.dtype, list(f.shape)] for f in spec.value_schema] \
        == json.loads(bytes(J[f"{dtype}|schema"]).decode())
    t, statuses = port_dtype_table(dtype)
    for i, status in enumerate(statuses):
        np.testing.assert_array_equal(status, J[f"{dtype}|status{i}"])

    _, q = dtype_stream(dtype)

    def same_lookup(table, prefix):
        found, got = table.lookup(q)
        np.testing.assert_array_equal(found.numpy(), J[f"{prefix}found"])
        for name in ("v", "w"):
            assert got[name].dtype == spec.field_dtypes()[name]
            np.testing.assert_array_equal(to_bits(got[name]),
                                          J[f"{prefix}{name}"], err_msg=name)

    same_lookup(t, f"{dtype}|got_")
    cap = spec.slab_rows
    for name, slab in t.slabs.items():
        np.testing.assert_array_equal(to_bits(slab[:cap]),
                                      J[f"{dtype}|slab_{name}"])

    path = t.save(str(tmp_path / "port.npz"))
    jpath = os.path.join(files, f"jax_{dtype}.npz")
    mine, theirs = S.load_image(path), S.load_image(jpath)
    assert mine.header == theirs.header
    assert mine.header["value_schema"][0][1] == dtype
    np.testing.assert_array_equal(mine.keys, theirs.keys)
    for name in ("v", "w"):
        np.testing.assert_array_equal(to_bits(mine.values[name]),
                                      to_bits(theirs.values[name]))
        if dtype == "bfloat16":     # the same 2-byte words in both files
            assert mine.values[name].dtype.str[1:] == "V2"
            assert theirs.values[name].dtype.str[1:] == "V2"

    # the port restores the JAX file and the JAX package's in-memory image
    # (its bfloat16 arrays are ml_dtypes.bfloat16)
    def mem(name):
        x = J[f"{dtype}|mem_{name}"]
        return x.view(jnp.bfloat16) if dtype == "bfloat16" else x

    memory = S.TableImage(
        header=json.loads(bytes(J[f"{dtype}|mem_header"]).decode()),
        keys=J[f"{dtype}|mem_keys"], values={n: mem(n) for n in ("v", "w")})
    for image in (S.load_image(jpath), memory):
        same_lookup(S.restore_from_image(image, spec, "cpu"), f"{dtype}|got_")
    # the JAX package restored the port's file of this stream, the file
    # this test's table writes
    fixture_file = S.load_image(os.path.join(files, f"port_{dtype}.npz"))
    assert fixture_file.header == mine.header
    np.testing.assert_array_equal(fixture_file.keys, mine.keys)
    for name in ("v", "w"):
        np.testing.assert_array_equal(to_bits(fixture_file.values[name]),
                                      to_bits(mine.values[name]))
    same_lookup(t, f"{dtype}|back_")


@pytest.mark.parametrize("declared", [torch.bfloat16, "bfloat16",
                                      jnp.bfloat16, np.dtype(jnp.bfloat16)])
def test_bfloat16_declarations(declared):
    """``bfloat16`` declared as a torch dtype, by name, or as the JAX
    package's type: one normal form, a ``torch.bfloat16`` slab."""
    spec = TableSpec(**GEOM, value_schema={"b": declared})
    assert spec.value_schema == (("b", "bfloat16", ()),)
    assert spec.field_dtypes() == {"b": torch.bfloat16}
    t = Table.create(spec, device="cpu")
    assert t.slabs["b"].dtype == torch.bfloat16


def test_64bit_fields_keep_full_width(tmp_path):
    """The port keeps 64-bit fields at full width through insert, lookup,
    save and restore (the JAX package, with x64 off, keeps 32 bits; a
    deliberate divergence, ROADMAP §3): 2**40 reads back as 2**40."""
    spec = TableSpec(**GEOM, value_schema={"i": "int64", "u": "uint64",
                                           "f": "float64"})
    t = Table.create(spec, device="cpu")
    keys = np.array([3, 5, 7], np.int32)
    want = {"i": torch.tensor([2**40, -2**40 - 1, 2**62], dtype=torch.int64),
            "u": torch.tensor([2**40, 2**63 + 5, 2**64 - 1],
                              dtype=torch.uint64),
            "f": torch.tensor([2.0**40 + 0.5, 1 / 3, -1e300],
                              dtype=torch.float64)}
    t, res = t.insert(keys, want)
    assert res.status.tolist() == [1, 1, 1]
    for table in (t, Table.restore(t.save(str(tmp_path / "wide.npz")), spec,
                                   device="cpu")):
        found, got = table.lookup(keys)
        assert found.all()
        for name, w in want.items():
            assert got[name].dtype == w.dtype
            assert torch.equal(got[name], w), name
    image = S.load_image(str(tmp_path / "wide.npz"))
    assert image.values["i"].dtype == np.int64
    assert int(image.values["i"][list(image.keys).index(3)]) == 2**40


if __name__ == "__main__":
    import sys
    assert sys.argv[1] == "--jax-dtypes", sys.argv
    sys.exit(_jax_dtypes(sys.argv[2], sys.argv[3]))
