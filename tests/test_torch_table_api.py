"""The PyTorch port's ``Table`` facade against the JAX package's.

The same seeded batches — lengths 0, 1, 12 and 3·n_lanes+5, mixed kinds,
``update``, ``merge`` — go through ``repro_torch.table_api.Table`` (both
plans, on the CPU) and ``repro.table_api.Table(backend="xla")``; statuses,
lookups, ``size``, ``depth`` and content must be equal. Lookups keep
``INT32_MIN`` out of the query stream: the JAX transaction-side lookup
matches it to a free slot, the port follows the fused probe kernel, under
which it is never found (pinned in ``test_torch_kernels.py``).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core.invariants import to_dict as jax_to_dict
from repro.core.spec import TableSpec as JaxSpec
from repro.table_api import Table as JaxTable
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.spec import TableSpec
from repro_torch.table_api import Table, from_numpy_state, to_numpy

jax.config.update("jax_platform_name", "cpu")

GEOM = dict(dmax=7, bucket_size=4, pool_size=128, n_lanes=8)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")


def same(port_out, jax_out, where):
    np.testing.assert_array_equal(port_out.cpu().numpy(),
                                  np.asarray(jax_out), err_msg=where)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_facade_matches_jax_facade(backend):
    facade_parity(GEOM, backend)


def test_unfused_facade_matches_jax_facade():
    """Rows wider than the fused apply kernel's 32 slots: the ``cuda``
    plan routes writes through ``grouped_apply`` and lookups through
    ``probe``, on the same batches as the fused test."""
    geom = dict(GEOM, bucket_size=40, pool_size=32)
    plan = facade_parity(geom, "cuda", min_merged=0)   # no pair fits 40
    assert not plan.fused_apply and not plan.fused_lookup


def facade_parity(geom, backend, min_merged=1):
    n = geom["n_lanes"]
    jt = JaxTable.create(JaxSpec(**geom, backend="xla"))
    t = Table.create(TableSpec(**geom, backend=backend), device="cpu")
    assert t.plan().backend == backend
    rng = np.random.default_rng(17)
    for rnd, m in enumerate([0, 1, 12, 3 * n + 5, 12, 1, 3 * n + 5, 0]):
        kinds = rng.integers(0, 3, size=m).astype(np.int32)
        keys = rng.integers(-300, 300, size=m).astype(np.int32)
        vals = rng.integers(0, 1 << 20, size=m).astype(np.int32)
        where = f"round {rnd} m={m}"
        jt, jr = jt.apply(kinds, keys, vals)
        t, tr = t.apply(kinds, keys, vals)
        assert tr.status.shape == (m,) and tr.status.dtype == torch.int8
        same(tr.status, jr.status, where)
        assert bool(tr.error) == bool(jr.error)
        upd = rng.integers(-300, 300, size=m).astype(np.int32)
        jt, jr = jt.update(upd, vals + 1)
        t, tr = t.update(upd, vals + 1)
        same(tr.status, jr.status, where + " update")
        if m == 12:     # one length each: every JAX batch length compiles
            jt, jr = jt.insert(keys[::-1], keys * 3)
            t, tr = t.insert(keys[::-1], keys * 3)
            same(tr.status, jr.status, where + " insert")
            dels = np.where(rng.random(m) < 0.3, keys, upd).astype(np.int32)
            jt, jr = jt.delete(dels)
            t, tr = t.delete(dels)
            same(tr.status, jr.status, where + " delete")
        q = np.where(rng.random(m) < 0.5, keys,
                     rng.integers(-400, 400, size=m)).astype(np.int32)
        for port_x, jax_x in zip(t.lookup(q), jt.lookup(q)):
            same(port_x, jax_x, where + " lookup")
        assert int(t.size()) == int(jt.size())
        assert int(t.depth()) == int(jt.depth())
        assert to_dict(t.config, t.state) == jax_to_dict(jt.config, jt.state)
        check_invariants(t.config, t.state, allow_error=bool(t.state.error))
    # merge: the first eight depth-1+ parents in turn, ok-flag and content
    # parity
    snap = to_numpy(t.state)
    parents = {(int(p) >> 1, int(d) - 1) for p, d, live in
               zip(snap["bprefix"], snap["bdepth"], snap["live"])
               if live and d >= 1}
    merged = 0
    for parent in sorted(parents)[:8]:
        jt, jok = jt.merge(*parent)
        t, tok = t.merge(*parent)
        assert bool(tok) == bool(jok), parent
        merged += bool(tok)
        assert int(t.depth()) == int(jt.depth())
        assert to_dict(t.config, t.state) == jax_to_dict(jt.config, jt.state)
    assert merged >= min_merged
    check_invariants(t.config, t.state)
    return t.plan()


def test_empty_and_single_batches():
    t = Table.create(TableSpec(**GEOM), device="cpu")
    empty = np.zeros(0, np.int32)
    t2, res = t.apply(empty, empty, empty)
    assert t2 is t and res.status.shape == (0,) and not bool(res.error)
    found, vals = t.lookup(empty)
    assert found.shape == (0,) and vals.shape == (0,)
    t, res = t.insert([42], [7])
    assert res.status.tolist() == [1] and int(t.size()) == 1 and t.seq == 1
    found, vals = t.lookup([42])
    assert found.tolist() == [True] and vals.tolist() == [7]
    t, res = t.delete(torch.tensor([42]))
    assert res.status.tolist() == [1] and int(t.size()) == 0


def test_spec_fields_match_jax_spec():
    assert ([f.name for f in dataclasses.fields(TableSpec)]
            == [f.name for f in dataclasses.fields(JaxSpec)])
    assert TableSpec(**GEOM).plan_batch(17) == JaxSpec(**GEOM).plan_batch(17)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        TableSpec(**GEOM, autotune="measured")
    # sharded placement is ported (tests/test_torch_dist.py): the spec
    # resolves as the JAX spec does, and the router, its closed-loop driver
    # and the chaos harness take it (tests/test_torch_router.py,
    # tests/test_torch_chaos.py)
    from repro_torch.serving.router import Router, default_cost_model
    from repro_torch.workloads import chaos_setup
    sharded = TableSpec(**GEOM, placement="sharded", shard_bits=2)
    jsharded = JaxSpec(**GEOM, placement="sharded", shard_bits=2)
    assert sharded.n_shards == jsharded.n_shards == 4
    assert (dataclasses.asdict(sharded.table_config())
            == dataclasses.asdict(jsharded.table_config()))
    t = Table.create(sharded, device="cpu")
    cm = default_cost_model(GEOM["n_lanes"])
    assert Router(t, cost_model=cm).queues.n_shards == 4
    assert chaos_setup("chaos_churn",
                       placement="sharded")[0].placement == "sharded"
    r = Router(Table.create(TableSpec(**GEOM), device="cpu"), cost_model=cm)
    r.handover(sharded, warmup=False)
    assert r.queues.depths() == [0] * 4
    # a geometry outside the fused-apply kernel resolves, on a CUDA table,
    # to the unfused kernels (grouped_apply, probe); the CPU tables match
    # the JAX facade
    geom = dict(dmax=10, bucket_size=8, pool_size=1024, n_lanes=1100,
                initial_depth=8)
    keys = np.arange(1, 1201, dtype=np.int32)
    jt, jres = JaxTable.create(JaxSpec(**geom, backend="xla")).insert(
        keys, keys * 5)
    for backend in ("auto", "cuda"):
        wide = TableSpec(**geom, backend=backend)
        plan = wide.plan("cuda")
        assert plan.backend == "cuda"
        assert plan.fused_lookup is plan.fused_apply is False
        t = Table.create(wide, device="cpu")
        t, res = t.insert(keys, keys * 5)
        same(res.status, jres.status, backend)
        assert bool((res.status == 1).all()) and t.seq == 2
        assert int(t.size()) == 1200
        assert to_dict(t.config, t.state) == jax_to_dict(jt.config, jt.state)
        for port_x, jax_x in zip(t.lookup(keys[::7] + 3),
                                 jt.lookup(keys[::7] + 3)):
            same(port_x, jax_x, backend + " lookup")


def test_numpy_state_round_trip():
    jt = JaxTable.create(JaxSpec(**GEOM, backend="xla"))
    jt, _ = jt.insert(np.arange(1, 40, dtype=np.int32),
                      np.arange(1, 40, dtype=np.int32))
    d = {f: np.asarray(getattr(jt.state, f)) for f in jt.state._fields}
    t = Table.from_state(TableSpec(**GEOM), from_numpy_state(d, "cpu"),
                         seq=int(jt.seq))
    back = to_numpy(t.state)
    for f, v in d.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)
        assert back[f].dtype == v.dtype, f
    found, vals = t.lookup(np.arange(1, 40, dtype=np.int32))
    assert found.all() and vals.tolist() == list(range(1, 40))


def test_create_without_device_needs_cuda():
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        Table.create(TableSpec(**GEOM))


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module, and chip_smoke.py, imports without jax or
    the repro package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = []
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
            names.append(m.name)
        importlib.import_module("chip_smoke")
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith(("jax.", "jaxlib"))
                     or k == "repro" or k.startswith("repro."))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.abspath(SRC), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 10
