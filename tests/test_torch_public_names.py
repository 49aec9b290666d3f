"""Module-level names of the JAX package that the PyTorch port carries
under the same names, each against its JAX counterpart on the CPU:

* ``table_api.create`` (the alias of ``Table.create``): the fresh table
  and the table after a mixed batch, state array for state array;
* ``core/table.py::insert_batch`` / ``delete_batch`` (one ``n_lanes``-wide
  transaction of upserts / deletes, fresh sequence numbers): statuses and
  every state array, trash row excepted, over a stream that splits
  buckets;
* ``core/reference.py::run_sequential`` (the oracle fed an op list):
  statuses, content and bucket layout, the identity hash as
  ``tests/test_core_table.py`` drives it.
"""
import jax
import numpy as np
import pytest
import torch

from repro import table_api as jax_api
from repro.core import reference as JR
from repro.core import table as JT
from repro.core.spec import TableSpec as JaxSpec
from repro_torch import table_api
from repro_torch.core import reference as R
from repro_torch.core import table as T

jax.config.update("jax_platform_name", "cpu")

GEOM = dict(dmax=8, bucket_size=4, pool_size=256, n_lanes=16)


def assert_same_state(st, jst, pool_size):
    for f, x in T.to_numpy(st).items():
        y = np.asarray(getattr(jst, f))
        if x.ndim and x.shape[0] == pool_size + 1:
            x, y = x[:pool_size], y[:pool_size]
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_create_matches_jax():
    kw = dict(GEOM, backend="plain")
    t = table_api.create(table_api.TableSpec(**kw), device="cpu")
    assert isinstance(t, table_api.Table) and t.mesh is None
    assert "create" in table_api.__all__
    jt = jax_api.create(JaxSpec(**dict(kw, backend="xla")))
    assert_same_state(t.state, jt.state, GEOM["pool_size"])
    rng = np.random.default_rng(5)
    kinds = rng.integers(0, 3, size=40).astype(np.int32)
    keys = rng.integers(1, 300, size=40).astype(np.int32)
    vals = rng.integers(0, 999, size=40).astype(np.int32)
    t, res = t.apply(kinds, keys, vals)
    jt, jres = jt.apply(kinds, keys, vals)
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    assert_same_state(t.state, jt.state, GEOM["pool_size"])
    # a sharded spec: the stacked table Table.create builds
    spec = table_api.TableSpec(**kw, placement="sharded", shard_bits=2)
    a = T.to_numpy(table_api.create(spec, "cpu").state)
    b = T.to_numpy(table_api.Table.create(spec, "cpu").state)
    assert a.keys() == b.keys() and a["keys"].shape[0] == 4
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_insert_and_delete_batch_match_jax():
    cfg = T.TableConfig(dmax=6, bucket_size=2, pool_size=64, n_lanes=8)
    jcfg = JT.TableConfig(dmax=6, bucket_size=2, pool_size=64, n_lanes=8)
    st, jst = T.init_table(cfg, "cpu"), JT.init_table(jcfg)
    rng = np.random.default_rng(11)
    live = []
    for step in range(10):
        if step % 3 == 2 and live:
            keys = rng.choice(live + [9999], size=8).astype(np.int32)
            st, res = T.delete_batch(cfg, st, torch.from_numpy(keys))
            jst, jres = JT.delete_batch(jcfg, jst, keys)
        else:
            keys = rng.integers(1, 200, size=8).astype(np.int32)
            vals = rng.integers(0, 999, size=8).astype(np.int32)
            st, res = T.insert_batch(cfg, st, torch.from_numpy(keys),
                                     torch.from_numpy(vals))
            jst, jres = JT.insert_batch(jcfg, jst, keys, vals)
            live += keys.tolist()
        np.testing.assert_array_equal(res.status.numpy(),
                                      np.asarray(jres.status))
        assert bool(res.error) == bool(jres.error)
        assert_same_state(st, jst, cfg.pool_size)
    assert int(st.depth) > 0
    with pytest.raises(ValueError):         # not n_lanes keys
        T.insert_batch(cfg, st, torch.arange(3, dtype=torch.int32),
                       torch.arange(3, dtype=torch.int32))


@pytest.mark.parametrize("hash_name", ["fmix32", "identity"])
def test_run_sequential_matches_jax(hash_name):
    rng = np.random.default_rng(3)
    ops = [("ins" if rng.random() < 0.7 else "del", int(k), int(v))
           for k, v in zip(rng.integers(0, 64, size=200),
                           rng.integers(0, 999, size=200))]
    t, statuses = R.run_sequential(ops, 8, 2, initial_depth=1,
                                   hash_name=hash_name)
    jt, jstatuses = JR.run_sequential(ops, 8, 2, initial_depth=1,
                                      hash_name=hash_name)
    assert statuses == jstatuses
    assert t.as_dict() == jt.as_dict()
    assert t.layout() == jt.layout()
    assert t.depth == jt.depth and t.split_count == jt.split_count
    with pytest.raises(ValueError):
        R.run_sequential([("upsert", 1, 2)], 8, 2)
