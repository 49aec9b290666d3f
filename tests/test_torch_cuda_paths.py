"""The value-schema and elastic-policy paths, and the baselines, on the card.

``cuda``-marked: each runs a table under the ``cuda`` plan (the CUDA
kernels) against the same table under the ``plain`` plan on the same op
stream, on the card — statuses, lookups (payloads or values) and
``to_dict`` equal, pool rows equal as sets (the lane-order kernel may put
a fresh insert in another free slot of its bucket), and the schema
table's slabs and liveness bitmap or the policy table's counters equal.
The baselines (``core/baselines.py``) run one stream on the card and on
the CPU: statuses, lookups and every state array equal. They skip where there is no card; the GPU machine has no JAX, so this file
imports none:

    python -m pytest -q -m cuda tests/test_torch_cuda_paths.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import snapshot as S
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.policy import ResizePolicy
from repro_torch.table_api import Table, TableSpec, to_numpy

SCHEMA = {"page": "int32", "score": ("float32", (2,))}
POLICY = ResizePolicy(split_watermark=0.75, merge_watermark=0.375,
                      max_splits=8, max_merges=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def payload(keys):
    keys = np.asarray(keys)
    return {"page": (keys * 5).astype(np.int32),
            "score": np.stack([keys / 3, keys / 7], -1).astype(np.float32)}


def assert_rows_equal_as_sets(a, b, P):
    ka, kb = to_numpy(a.state), to_numpy(b.state)
    for f in ("keys", "vals"):
        x = np.take_along_axis(ka[f][:P], np.argsort(ka["keys"][:P], 1), 1)
        y = np.take_along_axis(kb[f][:P], np.argsort(kb["keys"][:P], 1), 1)
        np.testing.assert_array_equal(x, y, err_msg=f)


def run_both(geom, spec_kw, batches, queries, values, cuda):
    """``batches`` of (kinds, keys) through a ``cuda``-plan and a
    ``plain``-plan table on the card; statuses and lookups equal after each.
    Returns the two tables."""
    ts = {b: Table.create(TableSpec(**geom, backend=b, **spec_kw),
                          device=cuda) for b in ("cuda", "plain")}
    for i, (kinds, keys) in enumerate(batches):
        outs = {}
        for b, t in ts.items():
            t, res = t.apply(kinds, keys, values(keys, i))
            ts[b] = t
            found, vals = t.lookup(queries)
            outs[b] = [res.status, found, t.state.policy_counts.clone()] + (
                [vals[k] for k in sorted(vals)] if isinstance(vals, dict)
                else [vals])
        for x, y in zip(outs["cuda"], outs["plain"]):
            assert torch.equal(x, y), f"batch {i}"
    assert ts["cuda"].plan().backend == "cuda"
    return ts["cuda"], ts["plain"]


@pytest.mark.cuda
def test_schema_cuda_plan_matches_plain_plan(cuda):
    geom = dict(dmax=12, bucket_size=8, pool_size=2048, n_lanes=64,
                initial_depth=6)
    rng = np.random.default_rng(9)
    universe = rng.choice(np.arange(1, 1 << 20), size=3000,
                          replace=False).astype(np.int32)
    batches = []
    for rnd in range(40):
        kinds = rng.integers(0, 3, size=150).astype(np.int32)
        kinds[: max(0, 100 - 3 * rnd)] = 1
        batches.append((kinds, rng.choice(universe, size=150)
                        .astype(np.int32)))
    a, p = run_both(geom, dict(value_schema=SCHEMA), batches, universe[:500],
                    lambda keys, i: payload(keys + i), cuda)
    assert to_dict(a.config, a.state) == to_dict(p.config, p.state)
    assert_rows_equal_as_sets(a, p, geom["pool_size"])
    cap = a.spec.slab_rows
    for name in a.slabs:
        assert torch.equal(a.slabs[name][:cap], p.slabs[name][:cap]), name
    assert torch.equal(a.slab_live, p.slab_live)
    assert int(a.slab_live.sum()) == int(a.size()) + 1
    check_invariants(a.config, a.state)


@pytest.mark.cuda
def test_policy_cuda_plan_matches_plain_plan(cuda):
    geom = dict(dmax=14, bucket_size=8, pool_size=8192, n_lanes=128,
                initial_depth=6)
    rng = np.random.default_rng(12)
    keys = rng.choice(np.arange(1, 1 << 24), size=12_000,
                      replace=False).astype(np.int32)
    batches = ([(np.ones(500, np.int32), keys[i:i + 500])
                for i in range(0, 12_000, 500)]
               + [(np.full(500, 2, np.int32), keys[i:i + 500])
                  for i in range(0, 11_000, 500)]
               + [(np.zeros(128, np.int32), np.zeros(128, np.int32))] * 20)
    policy = dataclasses.replace(POLICY, min_depth=6)
    a, p = run_both(geom, dict(resize_policy=policy), batches, keys[::7],
                    lambda ks, i: ks * 7, cuda)
    assert to_dict(a.config, a.state) == to_dict(p.config, p.state)
    splits, merges = (int(x) for x in a.state.policy_counts)
    assert splits > 0 and merges > 0
    assert_rows_equal_as_sets(a, p, geom["pool_size"])
    check_invariants(a.config, a.state)


DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
          "uint64", "float16", "float32", "float64", "bool", "bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dtype_on_the_card(dtype, cuda, tmp_path):
    """A scalar and a ``(2,)`` field of ``dtype`` under the ``cuda`` plan on
    the card and the ``plain`` plan on the CPU: equal statuses and payloads
    (unsigned and 64-bit values past 32 bits included), equal images, and
    each restores the other's image."""
    geom = dict(dmax=6, bucket_size=4, pool_size=64, n_lanes=8)
    schema = {"v": dtype, "w": (dtype, (2,))}
    tables = [Table.create(TableSpec(**geom, backend=b, value_schema=schema),
                           device=dev)
              for dev, b in ((cuda, "cuda"), (torch.device("cpu"), "plain"))]
    tdt = tables[0].spec.field_dtypes()["v"]
    rng = np.random.default_rng(DTYPES.index(dtype))

    def vals(keys):
        k = torch.as_tensor(np.asarray(keys, np.int64))
        if tdt == torch.bool:
            v = k % 3 == 0
        elif tdt.is_floating_point:
            v = (k % 256).to(tdt) / 4
        else:
            top = (2**63 - 1 if tdt in (torch.int64, torch.uint64)
                   else 2**31 - 1 if tdt in (torch.int32, torch.uint32)
                   else 2**15 - 1 if tdt in (torch.int16, torch.uint16)
                   else 2**7 - 1)
            v = (k * 7919 + top - 4000).to(tdt)
        return {"v": v, "w": torch.stack([v, v], -1)}

    keys = rng.choice(np.arange(1, 4000), size=48,
                      replace=False).astype(np.int32)
    batches = [(np.ones(48, np.int32), keys),
               (np.ones(24, np.int32), keys[:24]),
               (np.full(24, 2, np.int32), keys[12:36])]
    for _ in range(3):
        batches.append((rng.integers(0, 3, size=24).astype(np.int32),
                        rng.choice(np.r_[keys, keys + 4001],
                                   size=24).astype(np.int32)))
    for i, (kinds, ks) in enumerate(batches):
        st = []
        for j, t in enumerate(tables):
            tables[j], res = t.apply(kinds, ks, vals(ks.astype(np.int64) + i))
            st.append(res.status.cpu())
        assert torch.equal(st[0], st[1])
    q = np.r_[keys, keys + 4001].astype(np.int32)

    def read(t):
        found, got = t.lookup(q)
        return found.cpu(), {k: v.cpu() for k, v in got.items()}

    def same(got, want):
        assert torch.equal(got[0], want[0])
        for name, leaf in got[1].items():
            assert leaf.dtype == tdt and torch.equal(leaf, want[1][name]), name

    want = read(tables[1])
    same(read(tables[0]), want)
    paths = [t.save(str(tmp_path / f"{i}.npz")) for i, t in enumerate(tables)]
    a, b = (S.load_image(p) for p in paths)
    assert a.header == b.header
    for name in ("v", "w"):
        np.testing.assert_array_equal(a.values[name].view(np.uint8),
                                      b.values[name].view(np.uint8))
    for path, dev, backend in ((paths[1], cuda, "cuda"),
                               (paths[0], torch.device("cpu"), "plain")):
        same(read(Table.restore(path, TableSpec(**geom, backend=backend,
                                                value_schema=schema),
                                device=dev)), want)


@pytest.mark.cuda
def test_router_and_chaos_on_the_card(cuda):
    """The closed-loop driver with a handover, and a chaos run firing every
    event kind (``backend_swap`` across ``plain``/``cuda``/``auto``), on
    the card against their oracles."""
    from repro_torch.serving.router import RouterConfig, default_cost_model
    from repro_torch.workloads import serve_closed_loop
    from repro_torch.workloads.chaos import (EVENT_KINDS, chaos_replay,
                                             chaos_setup)

    spec = TableSpec(dmax=8, bucket_size=8, pool_size=512, n_lanes=8,
                     resize_policy=ResizePolicy())
    rep = serve_closed_loop(
        spec, n_clients=6, ops_per_client=50, device=cuda, mix="churn",
        seed=8, cost_model=default_cost_model(8),
        router_config=RouterConfig(max_batch=16, max_delay_s=1e-3),
        handover_at=0.5, handover_spec=dataclasses.replace(
            spec, dmax=9, pool_size=1024))
    assert rep["ok"] and rep["handovers"] == 1, rep["mismatch_examples"]
    spec, trace, schedule = chaos_setup("chaos_churn", seed=3, scale=0.4)
    rep = chaos_replay(spec, trace, schedule, device=cuda, oracle="both")
    assert rep["ok"], rep["mismatch_examples"]
    assert set(rep["event_counts"]) == set(EVENT_KINDS)
    assert rep["events_skipped"] == 0


@pytest.mark.cuda
def test_baselines_on_the_card_equal_the_cpu(cuda):
    """One stream through LF-Split, LF-Freeze-M and Lock on the card and on
    the CPU: statuses, lookups and every state array equal."""
    from repro_torch.core import baselines as BL

    n = 64
    rng = np.random.default_rng(9)
    universe = np.unique(rng.integers(1, 2**31 - 1, size=4096))[:3000]
    universe = rng.permutation(universe).astype(np.int32)
    structs = {
        "split": (BL.SplitConfig(depth=6, max_nodes=8192, n_lanes=n),
                  BL.split_init, BL.split_update, BL.split_lookup),
        "freeze": (BL.FreezeConfig(depth=6, bucket_size=8, pool_size=512,
                                   n_lanes=n),
                   BL.freeze_init, BL.freeze_update, BL.freeze_lookup),
        "lock": (BL.LockConfig(depth=6, bucket_size=64, n_lanes=n),
                 BL.lock_init, BL.lock_step, None),
    }
    for name, (cfg, init, update, lookup) in structs.items():
        states = {d: init(cfg, d) for d in (cuda, torch.device("cpu"))}
        for step in range(30):
            kinds = np.ones(n, np.int32) if step < 10 else rng.integers(
                1, 4 if lookup is None else 3, size=n).astype(np.int32)
            args = [kinds, rng.choice(universe, size=n, replace=False),
                    rng.integers(0, 2**31 - 1, size=n).astype(np.int32)]
            outs = {}
            for d, st in states.items():
                res = update(cfg, st, *(torch.tensor(x, device=d)
                                        for x in args))
                states[d] = res[0]
                outs[d] = list(res[1:]) + (
                    [] if lookup is None else list(lookup(
                        cfg, res[0], torch.tensor(universe, device=d))))
                outs[d] += list(res[0])
            for x, y in zip(*outs.values()):
                assert torch.equal(x.cpu(), y), f"{name} step {step}"
