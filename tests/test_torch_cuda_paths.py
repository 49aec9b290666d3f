"""The value-schema and elastic-policy paths, and the baselines, on the card.

``cuda``-marked: each runs a table under the ``cuda`` plan (the CUDA
kernels) against the same table under the ``plain`` plan on the same op
stream, on the card — statuses, lookups (payloads or values) and
``to_dict`` equal, pool rows equal as sets (the lane-order kernel may put
a fresh insert in another free slot of its bucket), and the schema
table's slabs and liveness bitmap or the policy table's counters equal.
The baselines (``core/baselines.py``) run one stream on the card and on
the CPU: statuses, lookups and every state array equal. Sharded tables
(``core/dist.py``, 2 and 4 shards, fused and unfused widths, raw and
with a value schema and the policy) run one stream on the card and on the
CPU: statuses, lookups and content equal, and every per-shard state array
equal with pool rows compared as sets. The smoke paged-KV engine and every
family's smoke ``decode_step`` run on the card against the CPU: logits at
the dtype's tolerance, the engine's integers equal, and the engine's
launches the fused kernels only. They skip where there is no card;
the GPU machine has no JAX, so this file imports none:

    python -m pytest -q -m cuda tests/test_torch_cuda_paths.py
"""
import dataclasses
import sys
from pathlib import Path

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


@pytest.mark.cuda
@pytest.mark.parametrize("shard_bits, lanes, extra", [
    (2, 512, {}),
    (1, 1100, {}),
    (2, 64, dict(value_schema=SCHEMA, resize_policy=POLICY)),
])
def test_sharded_streams_on_the_card_equal_the_cpu(cuda, shard_bits, lanes,
                                                   extra):
    """A sharded table on the card (the kernels per shard: fused at 512 and
    64 lanes, unfused at 1,100) against the same spec on the CPU (the
    plain plan)."""
    geom = dict(dmax=12, bucket_size=8, pool_size=2048, n_lanes=lanes,
                placement="sharded", shard_bits=shard_bits, **extra)
    ts = {d: Table.create(TableSpec(**geom), device=d)
          for d in (cuda, torch.device("cpu"))}
    assert ts[cuda].plan().backend == "cuda"
    assert ts[cuda].plan().fused_apply == (lanes <= 1024)
    rng = np.random.default_rng(shard_bits + lanes)
    universe = rng.integers(1, 2**31 - 1, size=6000).astype(np.int32)
    for step in range(24):
        m = int(rng.integers(lanes // 2, 2 * lanes))
        kinds = rng.choice([0, 1, 1, 2], size=m).astype(np.int32)
        keys = rng.choice(universe, size=m)
        vals = rng.integers(0, 2**31 - 1, size=m).astype(np.int32)
        q = rng.choice(universe, size=3 * lanes)
        outs = {}
        for d, t in ts.items():
            t, res = t.apply(kinds, keys, payload(vals) if "value_schema"
                             in extra else vals)
            ts[d] = t
            found, got = t.lookup(q)
            outs[d] = [res.status, found, t.state.policy_counts] + (
                [got[k] for k in sorted(got)] if isinstance(got, dict)
                else [got])
        for x, y in zip(*outs.values()):
            assert torch.equal(x.cpu(), y), f"step {step}"
    t_gpu, t_cpu = ts.values()
    check_invariants(t_gpu.config, t_gpu.state)
    assert to_dict(t_gpu.config, t_gpu.state) == to_dict(t_cpu.config,
                                                         t_cpu.state)
    a, b = to_numpy(t_gpu.state), to_numpy(t_cpu.state)
    P = geom["pool_size"]
    for f in a:
        x, y = a[f], b[f]
        if f in ("keys", "vals"):
            order_x = np.argsort(a["keys"][:, :P], -1)
            order_y = np.argsort(b["keys"][:, :P], -1)
            x = np.take_along_axis(x[:, :P], order_x, -1)
            y = np.take_along_axis(y[:, :P], order_y, -1)
        elif x.ndim >= 2 and x.shape[1] == P + 1:
            x, y = x[:, :P], y[:, :P]
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert not bool(t_gpu.state.error.any())


def _engine_stream(cfg, p, dev, backend, steps):
    """A smoke engine's stream on ``dev``: 4 slots admitted, ``steps``
    steps, slots 0 and 2 evicted and re-admitted, 6 more steps. Returns the
    logits, the final state's integers and the launches per step."""
    from repro_torch.kernels.apply import fused_apply, grouped_apply
    from repro_torch.kernels.lookup import fused_probe, probe
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KV

    kernels = (fused_probe, fused_apply, probe, grouped_apply)
    pc = E.make_paged_config(cfg, batch=4, max_len=32, page_size=4)
    pc = dataclasses.replace(pc, table=dataclasses.replace(
        pc.table, backend=backend))
    est = E.init_engine(cfg, pc, dev)
    est = est._replace(paged=KV.admit(pc, est.paged, np.ones(4, bool),
                                      np.arange(1, 5, dtype=np.int32)),
                       tokens=torch.ones(4, dtype=torch.int32, device=dev))
    logits, launches = [], []
    for i in range(steps + 6):
        if i == steps:
            mask = np.array([True, False, True, False])
            est = est._replace(paged=KV.admit(
                pc, KV.evict(pc, est.paged, mask), mask,
                np.array([10, 0, 11, 0], np.int32)))
        before = [f.launches for f in kernels]
        est, lg = E.serve_step(cfg, pc, est, p)
        launches.append([f.launches - b for f, b in zip(kernels, before)])
        logits.append(lg.float().cpu())
    st = est.paged
    ints = [S.extract_image(st.table).keys, st.page_alloc.cpu(),
            st.free_top.cpu(), st.free_pages.cpu(), st.lengths.cpu(),
            st.seq_ids.cpu()]
    return logits, ints, launches


@pytest.mark.cuda
def test_engine_on_the_card_equals_the_cpu(cuda):
    """The smoke ``deepseek-7b`` engine on the card (the fused kernels under
    the page table) against the same stream on the CPU: logits at the bf16
    tolerance, every integer of the state equal; on the card each step
    launches 4 ``fused_probe`` and 1 ``fused_apply`` and nothing else."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M

    cfg = smoke_config("deepseek-7b")
    p = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p_gpu = M.params_from_numpy(_chip_smoke().tree_numpy(p), cfg, cuda)
    got = _engine_stream(cfg, p_gpu, cuda, "auto", 14)
    want = _engine_stream(cfg, p, torch.device("cpu"), "auto", 14)
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-2, err_msg=f"step {i}")
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert all(step == [4, 1, 0, 0] for step in got[2]), got[2]


def _chip_smoke():
    """``chip_smoke.py`` from the repository's root, whose checks the card
    tests share."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-3),
                                        ("bfloat16", 2e-2)])
def test_decode_step_on_the_card_equals_the_cpu(cuda, dtype, tol):
    """``decode_step`` of every family's smoke config, 4 steps on the card
    against the CPU on the same weights and tokens."""
    _chip_smoke().family_decode_checks(1, cuda, [(dtype, tol)])
