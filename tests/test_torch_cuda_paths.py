"""The value-schema and elastic-policy paths on the card.

``cuda``-marked: each runs a table under the ``cuda`` plan (the CUDA
kernels) against the same table under the ``plain`` plan on the same op
stream, on the card — statuses, lookups (payloads or values) and
``to_dict`` equal, pool rows equal as sets (the lane-order kernel may put
a fresh insert in another free slot of its bucket), and the schema
table's slabs and liveness bitmap or the policy table's counters equal.
They skip where there is no card; the GPU machine has no JAX, so this file
imports none:

    python -m pytest -q -m cuda tests/test_torch_cuda_paths.py
"""
import dataclasses

import numpy as np
import pytest
import torch

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
