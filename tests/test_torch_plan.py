"""The port's ``KernelPlan``: resolution, hashing and dispatch.

The counterpart of the port-relevant half of ``tests/test_plan.py``. A
plan is resolved once per ``TableSpec`` and device type, from the spec's
``backend``, ``autotune`` and geometry alone: the resolution matrix over
``backend`` × device type, the fused kernels' geometry guards, hashable
plans whose tile provenance (``source``) is left out of equality and
hash, the facade exposing its plan, and applies and lookups routed by it
in the plan's tiles (the kernel wrappers run their plain versions on CPU
tensors, so a spy on each wrapper shows which one a plan reaches and with
which launch shape). ``autotune="measured"`` under the ``cuda`` backend
on the CPU runs the measured sweep through the plain versions: the first
resolution measures, the next (registry cleared) reads the on-disk cache,
and the table's statuses, lookups and content equal an ``autotune="off"``
table's and the JAX ``backend="xla"`` table's. The wrappers refuse a
launch shape outside the kernels' sets. The JAX plan's environment
overrides (``REPRO_FUSED_APPLY``, ``REPRO_FORCE_INTERPRET``,
``REPRO_AUTOTUNE``, the tile variables) have no counterpart: the port's
plan reads no environment variable (``tests/test_torch_tuning.py`` holds
the tuning module to the same).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import table as T
from repro_torch.kernels import apply as kapply
from repro_torch.kernels import lookup as klookup
from repro_torch.kernels import ops as kops
from repro_torch.kernels.apply import MAX_BUCKET_SIZE, MAX_LANES
from repro_torch.kernels.plan import KernelPlan, resolve_plan, spread_rows
from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import TileConfig
from repro_torch.table_api import Table, TableSpec

SMALL = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8)
JAX_ENV = ("REPRO_FORCE_INTERPRET", "REPRO_FUSED_APPLY", "REPRO_AUTOTUNE",
           "REPRO_TILE_TQ", "REPRO_TILE_PC", "REPRO_TILE_DC")


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("backend,expect", [
    ("plain", {"cpu": "plain", "cuda": "plain"}),
    ("cuda", {"cpu": "cuda", "cuda": "cuda"}),
    ("auto", {"cpu": "plain", "cuda": "cuda"}),
])
def test_resolution_matrix(backend, expect, device_type):
    plan = resolve_plan(TableSpec(**SMALL, backend=backend), device_type)
    assert plan.backend == expect[device_type]
    # the small geometry is inside the fused kernels' bound
    fused = plan.backend == "cuda"
    assert (plan.fused_apply, plan.fused_lookup) == (fused, fused)


def test_resolution_rejects_unknown_names():
    with pytest.raises(ValueError, match="backend"):
        TableSpec(**SMALL, backend="pallas")
    with pytest.raises(ValueError, match="device type"):
        resolve_plan(TableSpec(**SMALL), "tpu")


@pytest.mark.parametrize("n_lanes,bucket_size,fused", [
    (1, 1, True), (MAX_LANES, MAX_BUCKET_SIZE, True),
    (MAX_LANES + 1, 8, False), (8, MAX_BUCKET_SIZE + 1, False),
    (4096, 8, False),
])
def test_fused_geometry_guards(n_lanes, bucket_size, fused):
    assert kapply.fused_apply_supported(n_lanes, bucket_size) == fused
    spec = TableSpec(dmax=6, bucket_size=bucket_size,
                     pool_size=max(64, bucket_size), n_lanes=n_lanes,
                     backend="cuda")
    plan = spec.plan("cuda")
    # a table whose writes leave the fused kernel routes its lookups the
    # same way
    assert plan.fused_apply == plan.fused_lookup == fused
    assert not kapply.fused_apply_supported(0, 8)
    assert not kapply.fused_apply_supported(8, 0)


def test_plan_is_hashable_and_resolved_once():
    a = resolve_plan(TableSpec(**SMALL, backend="cuda"), "cpu")
    # the default tiles clamped to the 8-lane nominal width: a 1,024-lane
    # chunk holds the batch
    tiles = TileConfig(block=64, chunk=1024)
    b = KernelPlan("cuda", fused_lookup=True, fused_apply=True,
                   lookup_tiles=tiles, apply_tiles=tiles)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert {a: 1}[b] == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.backend = "plain"
    spec = TableSpec(**SMALL, backend="auto")
    assert spec.plan("cpu") is spec.plan("cpu")
    assert spec.plan("cuda") is spec.plan("cuda")
    # specs still compare and hash on their fields alone
    assert TableSpec(**SMALL) == TableSpec(**SMALL)
    assert hash(TableSpec(**SMALL)) == hash(TableSpec(**SMALL))


def test_plan_reads_no_environment(monkeypatch):
    """The JAX plan's overrides (``REPRO_FUSED_APPLY=0`` turns its fused
    apply off) change nothing here."""
    want = {b: resolve_plan(TableSpec(**SMALL, backend=b), d)
            for b in ("auto", "plain", "cuda") for d in ("cpu", "cuda")}
    for var, value in zip(JAX_ENV, ("1", "0", "measured", "8", "8", "8")):
        monkeypatch.setenv(var, value)
    got = {b: resolve_plan(TableSpec(**SMALL, backend=b), d)
           for b in ("auto", "plain", "cuda") for d in ("cpu", "cuda")}
    assert got == want
    assert got["cuda"].fused_apply


@pytest.mark.parametrize("backend", ["plain", "cuda", "auto"])
def test_table_facade_exposes_plan(backend):
    spec = TableSpec(**SMALL, backend=backend)
    t = Table.create(spec, device="cpu")
    assert t.plan() is spec.plan("cpu")
    assert t.plan().backend == ("plain" if backend == "auto" else backend)
    assert f"backend={t.plan().backend}" in repr(t)


class Spy:
    """Counts the calls of a kernel wrapper and forwards them."""

    def __init__(self, monkeypatch, module, name):
        self.calls, self.fn = 0, getattr(module, name)
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


WRAPPERS = ((kapply, "fused_apply"), (kapply, "grouped_apply"),
            (klookup, "fused_probe"), (klookup, "probe"))
PLANS = {"plain": KernelPlan("plain"),
         "cuda": KernelPlan("cuda"),
         "cuda_unfused": KernelPlan("cuda", fused_lookup=False,
                                    fused_apply=False)}
# the wrapper each plan reaches for (apply, lookup)
REACHES = {"plain": (), "cuda": ("fused_apply", "fused_probe"),
           "cuda_unfused": ("grouped_apply", "probe")}


def test_applies_and_lookups_routed_by_plan(monkeypatch):
    """Each plan reaches exactly its wrappers (none for ``plain``), and
    every plan gives the same statuses, lookups and content."""
    cfg = TableSpec(**SMALL).table_config()
    rng = np.random.default_rng(0)
    batches = [(rng.integers(1, 3, size=8).astype(np.int32),
                rng.integers(1, 40, size=8).astype(np.int32))
               for _ in range(6)]
    queries = torch.arange(1, 40, dtype=torch.int32)
    outs = {}
    for name, plan in PLANS.items():
        spies = {n: Spy(monkeypatch, m, n) for m, n in WRAPPERS}
        s, seen = T.init_table(cfg, "cpu"), []
        for kinds, keys in batches:
            s, res = kops.plan_apply(plan, cfg, s, T.make_ops(
                cfg, s, kinds, keys, keys * 3))
            seen += [res.status, *kops.plan_lookup(plan, cfg, s, queries)]
        outs[name] = seen
        assert {n for n, sp in spies.items() if sp.calls} == set(
            REACHES[name]), name
        for n in REACHES[name]:
            assert spies[n].calls == len(batches), (name, n)
        monkeypatch.undo()
    for name in ("cuda", "cuda_unfused"):
        for a, b in zip(outs[name], outs["plain"]):
            assert torch.equal(a, b), name


def test_plan_with_tiles_is_hashable_and_source_free():
    """Two plans that differ only in ``source`` compare and hash equal;
    plans with other tiles do not."""
    a = resolve_plan(TableSpec(**SMALL, backend="cuda"), "cpu")
    assert a.source == "heuristic" and a.autotune == "off"
    b = dataclasses.replace(a, source="measured")
    c = dataclasses.replace(a, source="cache", autotune="measured")
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert c != a       # the policy is part of the plan, the source is not
    assert dataclasses.replace(c, source="measured") == c
    d = dataclasses.replace(a, lookup_tiles=TileConfig(block=32))
    assert d != a and len({a, b, d}) == 2
    with pytest.raises(AssertionError):
        KernelPlan("cuda", source="env")


UNFUSED = dict(dmax=8, bucket_size=40, pool_size=256, n_lanes=32)


@pytest.mark.parametrize("geom", [dict(dmax=8, bucket_size=4,
                                       pool_size=256, n_lanes=32), UNFUSED],
                         ids=["fused", "unfused"])
def test_measured_plan_on_the_cpu_then_cached(geom, tmp_path, monkeypatch):
    """``autotune="measured"`` under the ``cuda`` backend on the CPU: the
    sweep runs through the plain versions (``measured``); after
    ``clear_registry()`` the on-disk cache answers (``cache``, the runner
    never called) with the same tiles. Over one mixed stream the measured
    table's statuses, lookups and content equal an ``autotune="off"``
    table's and the JAX ``backend="xla"`` table's."""
    import jax

    from repro.core.invariants import to_dict as jax_to_dict
    from repro.core.spec import TableSpec as JaxSpec
    from repro.table_api import Table as JaxTable
    from repro_torch.core.invariants import to_dict

    jax.config.update("jax_platform_name", "cpu")
    monkeypatch.setattr(tuning, "cache_path", lambda: tmp_path / "t.json")
    tuning.clear_registry()
    try:
        calls = tuning.autotune.runner_calls
        s1 = TableSpec(**geom, backend="cuda", autotune="measured")
        p1 = s1.plan("cpu")
        assert p1.source == "measured" and p1.autotune == "measured"
        assert tuning.autotune.runner_calls > calls
        assert (p1.fused_apply, p1.fused_lookup) == (
            (geom["bucket_size"] <= 32,) * 2)
        tuning.clear_registry()   # the cache outlives a process, pins not
        calls = tuning.autotune.runner_calls
        s2 = TableSpec(**geom, backend="cuda", autotune="measured")
        p2 = s2.plan("cpu")
        assert p2.source == "cache" and tuning.autotune.runner_calls == calls
        assert (p2.lookup_tiles, p2.apply_tiles) == (p1.lookup_tiles,
                                                     p1.apply_tiles)
        assert p1 == p2 and hash(p1) == hash(p2)
        tuning.clear_registry()

        rng = np.random.default_rng(5)
        tables = {"measured": Table.create(s2, "cpu"),
                  "off": Table.create(TableSpec(**geom, backend="cuda"),
                                      "cpu")}
        assert tables["measured"].plan() is p2
        jt = JaxTable.create(JaxSpec(**geom, backend="xla"))
        queries = np.arange(1, 400, dtype=np.int32)
        for step in range(6):
            m = int(rng.integers(1, 3 * geom["n_lanes"]))
            kinds = rng.integers(0, 3, size=m).astype(np.int32)
            keys = rng.integers(1, 400, size=m).astype(np.int32)
            vals = rng.integers(0, 1 << 20, size=m).astype(np.int32)
            jt, jres = jt.apply(kinds, keys, vals)
            jf, jv = jt.lookup(queries)
            for name, t in tables.items():
                t, res = t.apply(kinds, keys, vals)
                tables[name] = t
                f, v = t.lookup(queries)
                where = f"{name} step {step}"
                np.testing.assert_array_equal(
                    res.status.numpy(), np.asarray(jres.status), where)
                np.testing.assert_array_equal(f.numpy(), np.asarray(jf),
                                              where)
                np.testing.assert_array_equal(v.numpy(), np.asarray(jv),
                                              where)
        want = jax_to_dict(jt.config, jt.state)
        assert want
        for t in tables.values():
            assert to_dict(t.config, t.state) == want
    finally:
        tuning.clear_registry()


def test_plan_tiles_reach_the_wrappers(monkeypatch):
    """``plan_lookup`` / ``plan_apply`` hand the plan's tiles to the kernel
    wrappers: ``block`` to both probes, ``chunk`` to ``grouped_apply``; a
    sharded table's facade (``core/dist.py``) passes its plan's the same
    way."""
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def call(*args, **kw):
            seen.append((name, kw.get("block"), kw.get("chunk")))
            return real(*args, **kw)
        monkeypatch.setattr(module, name, call)

    for module, name in WRAPPERS:
        spy(module, name)
    tiles = dict(lookup_tiles=TileConfig(block=128),
                 apply_tiles=TileConfig(chunk=2048))
    cfg = TableSpec(**SMALL).table_config()
    queries = torch.arange(1, 40, dtype=torch.int32)
    for fused in (True, False):
        plan = KernelPlan("cuda", fused_lookup=fused, fused_apply=fused,
                          **tiles)
        s = T.init_table(cfg, "cpu")
        s, _ = kops.plan_apply(plan, cfg, s, T.make_ops(
            cfg, s, np.full(8, 1, np.int32), np.arange(1, 9, dtype=np.int32),
            np.arange(8, dtype=np.int32)))
        kops.plan_lookup(plan, cfg, s, queries)
    assert seen == [("fused_apply", None, None), ("fused_probe", 128, None),
                    ("grouped_apply", None, 2048), ("probe", 128, None)]

    # the sharded facade, with the tiles pinned for its per-shard geometry
    seen.clear()
    geom = dict(dmax=6, bucket_size=40, pool_size=64, n_lanes=8,
                placement="sharded", shard_bits=1)
    lcfg = TableSpec(**geom).table_config()
    try:
        for kind, t in (("lookup", TileConfig(block=256)),
                        ("apply", TileConfig(chunk=2048))):
            tuning.register_tiles(tuning.tile_key(
                kind, dmax=lcfg.dmax, pool_size=lcfg.pool_size, n_lanes=8),
                t)
        tab = Table.create(TableSpec(**geom, backend="cuda"), "cpu")
        assert tab.plan().lookup_tiles.block == 256
        tab, _ = tab.insert([3, 4, 5], [30, 40, 50])
        found, vals = tab.lookup([3, 4, 6])
    finally:
        tuning.clear_registry()
    assert found.tolist() == [True, True, False]
    assert vals.tolist()[:2] == [30, 40]
    # one launch per shard per facade call, each in the plan's tiles
    assert {x for x in seen if x[0] == "probe"} == {("probe", 256, None)}
    assert {x for x in seen if x[0] == "grouped_apply"} == {
        ("grouped_apply", None, 1024)}   # 2048 clamped to 8 lanes


def test_wrappers_reject_unknown_tiles():
    """A launch shape outside the kernels' sets raises ``ValueError``
    before any launch, on any device; the plain versions take the
    argument and ignore it."""
    directory = torch.zeros(16, dtype=torch.int32)
    pk = torch.full((5, 4), T.EMPTY_KEY, dtype=torch.int32)
    pv = torch.zeros((5, 4), dtype=torch.int32)
    q = torch.arange(3, dtype=torch.int32)
    bids = torch.zeros(3, dtype=torch.int32)
    for block in (0, 16, 48, 512, 64.0, None):
        with pytest.raises(ValueError, match="block"):
            klookup.fused_probe(directory, q, pk[:-1], pv[:-1], dmax=4,
                                block=block)
        with pytest.raises(ValueError, match="block"):
            klookup.probe(bids, q, pk[:-1], pv[:-1], block=block)
    for chunk in (0, 512, 3000, 8192, None):
        with pytest.raises(ValueError, match="chunk"):
            kapply.grouped_apply(q, q, q, bids, pk, pv, chunk=chunk)
    for block in tuning.BLOCKS:
        a = klookup.fused_probe(directory, q, pk[:-1], pv[:-1], dmax=4,
                                block=block)
        b = klookup.fused_probe_plain(directory, q, pk[:-1], pv[:-1],
                                      dmax=4, block=512)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        a = klookup.probe(bids, q, pk[:-1], pv[:-1], block=block)
        b = klookup.probe_plain(bids, q, pk[:-1], pv[:-1], block=7)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for chunk in tuning.CHUNKS:
        a = kapply.grouped_apply(q, q, q, bids, pk.clone(), pv.clone(),
                                 chunk=chunk)
        b = kapply.grouped_apply_plain(q, q, q, bids, pk.clone(),
                                       pv.clone(), chunk=3)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n,rows", [(8, 64), (512, 2**20), (4096, 2**20),
                                    (4096, 2**31 - 1), (10, 3)])
def test_sweep_bucket_ids_stay_in_the_pool(n, rows):
    """The apply sweep's bucket ids lie in ``[0, rows)``, spread over the
    pool, also where ``n * rows`` passes 2**31 (the wide geometry)."""
    b = spread_rows(n, rows, "cpu")
    assert b.dtype == torch.int32 and b.shape == (n,)
    assert int(b.min()) == 0 and int(b.max()) < rows
    assert bool((b[1:] >= b[:-1]).all())
    assert int(b.max()) == (n - 1) * rows // n
