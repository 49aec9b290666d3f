"""The port's ``KernelPlan``: resolution, hashing and dispatch.

The counterpart of the port-relevant half of ``tests/test_plan.py``. A
plan is resolved once per ``TableSpec`` and device type, from the spec's
``backend`` and geometry alone: the resolution matrix over ``backend`` ×
device type, the fused kernels' geometry guards, hashable plans, the
facade exposing its plan, and applies and lookups routed by it (the
kernel wrappers run their plain versions on CPU tensors, so a spy on
each wrapper shows which one a plan reaches). The JAX plan's
environment overrides (``REPRO_FUSED_APPLY``, ``REPRO_FORCE_INTERPRET``,
the tile variables) and its measured autotuner have no counterpart: the
port's plan reads no environment variable.
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
from repro_torch.kernels.plan import KernelPlan, resolve_plan
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
    b = KernelPlan("cuda", fused_lookup=True, fused_apply=True)
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
