"""The PyTorch port's sharded placement against the JAX package's.

The counterpart of ``tests/test_dist_table.py`` and
``tests/test_dist_parity.py``. The JAX side runs once, in a subprocess with
8 forced host devices (XLA's device count is process-global): a mesh
``(4, 2)`` carries a 2-shard table and ``(2, 4)`` a 4-shard one
(``backend="xla"``). Under ``jax.make_mesh``'s default explicit axes the
JAX facade's sharded ``apply`` fails (a batch longer than ``n_lanes``: its
chunk ``scan`` output does not reshape; schema mode: a ``select`` of mixed
shardings), so the meshes here have automatic axes, and both sides are
driven one ``n_lanes``-wide chunk per call, which is what that ``scan``
would do. The subprocess writes its
statuses, lookups, stacked state arrays, images, payloads, slabs and
``size`` / ``depth`` / ``policy_stats`` to an ``.npz``; the port (``plain``
plan, on the CPU) runs the same streams here and must equal them array for
array (the per-shard trash rows excepted), with NOP lanes and same-key
lanes in the batches. The union content must equal ``SeqExtHash`` over the
aggregate ``dmax + shard_bits`` bits; a JAX sharded state must load into
the port through ``from_numpy_state`` and continue identically; and a
shard that doubles its directory inside a sharded transaction must leave
the deeper directory in the stacked state.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import dist as D
from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.reference import SeqExtHash
from repro_torch.core.snapshot import extract_image
from repro_torch.table_api import (Table, TableSpec, from_numpy_state,
                                   to_numpy)

HERE = os.path.abspath(__file__)
N = 16                      # lanes per transaction
QUERIES = 40                # per step; the facade pads lookups to 48
SCHEMA = {"page": "int32", "score": ("float32", (2,))}
POLICY = dict(split_watermark=0.75, merge_watermark=0.375, max_splits=8,
              max_merges=4)
GEOM = dict(dmax=8, bucket_size=4, pool_size=256, n_lanes=N)
# name -> (shard_bits, spec extras, steps, carry step or None)
CASES = {
    "raw2": (1, {}, 40, None),
    "policy4": (2, {"policy": True}, 48, 24),
    "schema2": (1, {"schema": True}, 30, None),
}


def steps(name):
    """The case's op stream: ``n_lanes``-wide batches of NOP / INS / DEL
    lanes over a few hundred keys (same-key lanes within a batch), an
    insert-heavy first half and a delete-heavy second half, and a query
    batch per step."""
    _, _, n_steps, _ = CASES[name]
    rng = np.random.default_rng(len(name) * 31 + n_steps)
    out = []
    for s in range(n_steps):
        p_ins = 0.75 if s < n_steps // 2 else 0.2
        kinds = rng.choice(3, size=N, p=[0.1, 0.9 * p_ins,
                                         0.9 * (1 - p_ins)]).astype(np.int32)
        keys = rng.integers(1, 400, size=N).astype(np.int32)
        vals = rng.integers(0, 2**31 - 1, size=N).astype(np.int32)
        q = rng.integers(1, 440, size=QUERIES).astype(np.int32)
        out.append((kinds, keys, vals, q))
    return out


def payload(keys, vals):
    return {"page": vals,
            "score": np.stack([keys / 2, vals / 4], -1).astype(np.float32)}


def spec_kw(name):
    shard_bits, extra, _, _ = CASES[name]
    return dict(GEOM, placement="sharded", shard_bits=shard_bits), extra


# ---------------------------------------------------------------------------
# the JAX side (subprocess)


def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import compat
    from repro.core.policy import ResizePolicy as JaxPolicy
    from repro.core.snapshot import extract_image as jax_image
    from repro.core.spec import TableSpec as JaxSpec
    from repro.table_api import Table as JaxTable

    out = {}
    for name in CASES:
        kw, extra = spec_kw(name)
        n_shards = 1 << kw["shard_bits"]
        mesh = jax.make_mesh((8 // n_shards, n_shards), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        schema = ({"page": jnp.int32, "score": (jnp.float32, (2,))}
                  if extra.get("schema") else None)
        spec = JaxSpec(**kw, backend="xla", value_schema=schema,
                       resize_policy=(JaxPolicy(**POLICY)
                                      if extra.get("policy") else None))
        carry = CASES[name][3]
        with compat.set_mesh(mesh):
            t = JaxTable.create(spec, mesh)
            statuses, found, vals = [], [], []
            for s, (kinds, keys, v, q) in enumerate(steps(name)):
                if s == carry:
                    for f, x in t.state._asdict().items():
                        out[f"{name}__mid__{f}"] = np.asarray(x)
                    out[f"{name}__mid_seq"] = np.asarray(t.seq)
                values = payload(keys, v) if schema else v
                t, res = t.apply(kinds, keys, values)
                jax.block_until_ready(t.state)
                statuses.append(np.asarray(res.status))
                f, got = t.lookup(q)
                found.append(np.asarray(f))
                vals.append(np.asarray(got["page"]) if schema
                            else np.asarray(got))
            out[f"{name}__status"] = np.stack(statuses)
            out[f"{name}__found"] = np.stack(found)
            out[f"{name}__vals"] = np.stack(vals)
            for f, x in t.state._asdict().items():
                out[f"{name}__state__{f}"] = np.asarray(x)
            st = t.policy_stats()
            out[f"{name}__stats"] = np.asarray(
                [int(t.size()), int(t.depth()), int(st["splits"]),
                 int(st["merges"])])
            out[f"{name}__pressure"] = np.asarray(st["pressure"])
            out[f"{name}__error"] = np.asarray(t.state.error)
            img = jax_image(t)
            out[f"{name}__image_keys"] = img.keys
            if schema:
                for f in ("page", "score"):
                    out[f"{name}__image_{f}"] = img.values[f]
                    out[f"{name}__slab_{f}"] = np.asarray(t.slabs[f])
                out[f"{name}__slab_live"] = np.asarray(t.slab_live)
            else:
                out[f"{name}__image_vals"] = img.values
    np.savez(out_path, **out)
    print("jax side OK")
    return 0


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_dist") / "jax.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(HERE), "..", "src"))
    proc = subprocess.run([sys.executable, HERE, "--jax-side", path],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# the port side


def port_spec(name):
    kw, extra = spec_kw(name)
    from repro_torch.core.policy import ResizePolicy
    return TableSpec(**kw, value_schema=SCHEMA if extra.get("schema")
                     else None,
                     resize_policy=(ResizePolicy(**POLICY)
                                    if extra.get("policy") else None))


def run_port(name, table=None, first=0):
    """The case's stream (from step ``first``) through a port table.
    Returns (table, statuses, found, values)."""
    spec = port_spec(name)
    t = table or Table.create(spec, device="cpu")
    statuses, found, vals = [], [], []
    for kinds, keys, v, q in steps(name)[first:]:
        values = payload(keys, v) if spec.value_schema else v
        t, res = t.apply(kinds, keys, values)
        statuses.append(res.status.numpy())
        f, got = t.lookup(q)
        found.append(f.numpy())
        vals.append((got["page"] if spec.value_schema else got).numpy())
    return t, np.stack(statuses), np.stack(found), np.stack(vals)


@pytest.fixture(scope="module")
def port_run():
    """``run_port(name)`` of each case, run once per module (the tests
    only read the tables)."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = run_port(name)
        return runs[name]
    return get


def assert_same_stacked_state(t, jax_run, prefix):
    P = t.spec.pool_size
    for f, x in to_numpy(t.state).items():
        y = jax_run[f"{prefix}__{f}"]
        assert x.shape == y.shape, f
        if x.ndim >= 2 and x.shape[1] == P + 1:
            x, y = x[:, :P], y[:, :P]       # the per-shard trash rows
        np.testing.assert_array_equal(x, y, err_msg=f"{prefix}: {f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_statuses_and_lookups_match_jax(jax_run, port_run, name):
    t, status, found, vals = port_run(name)
    np.testing.assert_array_equal(status, jax_run[f"{name}__status"])
    np.testing.assert_array_equal(found, jax_run[f"{name}__found"])
    np.testing.assert_array_equal(vals, jax_run[f"{name}__vals"])
    kinds = np.stack([k for k, *_ in steps(name)])
    assert (status[kinds == T.NOP] == 0).all()      # NOP lanes: status 0
    assert ((status != 0) & (status != 1)).sum() == 0
    assert not bool(jax_run[f"{name}__error"].any())


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_state_matches_jax(jax_run, port_run, name):
    t, *_ = port_run(name)
    assert t.state.directory.shape == (t.spec.n_shards, 1 << GEOM["dmax"])
    assert_same_stacked_state(t, jax_run, f"{name}__state")
    check_invariants(t.config, t.state)


@pytest.mark.parametrize("name", sorted(CASES))
def test_size_depth_policy_stats_match_jax(jax_run, port_run, name):
    t, *_ = port_run(name)
    st = t.policy_stats()
    got = [int(t.size()), int(t.depth()), int(st["splits"]),
           int(st["merges"])]
    assert got == jax_run[f"{name}__stats"].tolist()
    assert float(st["pressure"]) == float(jax_run[f"{name}__pressure"])
    if port_spec(name).resize_policy is not None:
        assert got[2] > 0 and got[3] > 0, got
    assert int(t.depth()) == int(t.state.depth.max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_images_and_payloads_match_jax(jax_run, port_run, name):
    t, *_ = port_run(name)
    img = extract_image(t)
    np.testing.assert_array_equal(img.keys, jax_run[f"{name}__image_keys"])
    if t.spec.value_schema is None:
        np.testing.assert_array_equal(img.values,
                                      jax_run[f"{name}__image_vals"])
        return
    for f in ("page", "score"):
        np.testing.assert_array_equal(img.values[f],
                                      jax_run[f"{name}__image_{f}"])
        np.testing.assert_array_equal(t.slabs[f].numpy(),
                                      jax_run[f"{name}__slab_{f}"])
    np.testing.assert_array_equal(t.slab_live.numpy(),
                                  jax_run[f"{name}__slab_live"])


def test_jax_sharded_state_continues_in_the_port(jax_run):
    """The JAX table's stacked state, halfway, loads through
    ``from_numpy_state`` and the rest of the stream gives the JAX run's
    statuses, lookups and final state."""
    name = "policy4"
    carry = CASES[name][3]
    mid = {f: jax_run[f"{name}__mid__{f}"] for f in T.TableState._fields}
    st = from_numpy_state(mid, device="cpu")
    t = Table.from_state(port_spec(name), st,
                         seq=int(jax_run[f"{name}__mid_seq"]))
    t, status, found, vals = run_port(name, t, first=carry)
    np.testing.assert_array_equal(status,
                                  jax_run[f"{name}__status"][carry:])
    np.testing.assert_array_equal(found, jax_run[f"{name}__found"][carry:])
    np.testing.assert_array_equal(vals, jax_run[f"{name}__vals"][carry:])
    assert_same_stacked_state(t, jax_run, f"{name}__state")


@pytest.mark.parametrize("shard_bits", [1, 2])
def test_union_content_equals_seq_ext_hash(shard_bits):
    """Distinct keys per batch (the reference's lane order then equals
    every shard's): statuses lane for lane and the union of the shards'
    maps equal ``SeqExtHash`` over ``dmax + shard_bits`` bits."""
    spec = TableSpec(**GEOM, placement="sharded", shard_bits=shard_bits)
    t = Table.create(spec, device="cpu")
    ref = SeqExtHash(dmax=GEOM["dmax"] + shard_bits, bucket_size=4)
    rng = np.random.default_rng(shard_bits)
    for _ in range(24):
        m = int(rng.integers(5, 3 * N))        # chunked by the facade
        kinds = rng.integers(1, 3, size=m).astype(np.int32)
        keys = rng.choice(np.arange(1, 3000), size=m,
                          replace=False).astype(np.int32)
        vals = rng.integers(0, 999, size=m).astype(np.int32)
        t, res = t.apply(kinds, keys, vals)
        want = [ref.insert(int(k), int(v)) if c == T.INS
                else ref.delete(int(k)) for c, k, v in zip(kinds, keys, vals)]
        assert res.status.tolist() == want
        assert not bool(res.error)
    assert to_dict(t.config, t.state) == ref.as_dict()
    q = np.arange(1, 3000, dtype=np.int32)
    found, vals = t.lookup(q)
    ref_map = ref.as_dict()
    assert found.tolist() == [int(k) in ref_map for k in q]
    assert vals.tolist() == [ref_map.get(int(k), -1) for k in q]
    assert int(t.size()) == len(ref_map)


def test_directory_doubling_lands_in_the_stacked_state():
    """One transaction drives shard 0 from depth 0 to a doubled directory:
    the stacked state holds the shard's new directory, depth, allocator
    and per-lane results — equal to the same ops through a lone per-shard
    table — while shard 1 stays untouched."""
    spec = TableSpec(**GEOM, placement="sharded", shard_bits=1)
    dcfg = spec.dist_config()
    keys = np.arange(1, 4000, dtype=np.int32)
    mine = keys[D._dest_shard(dcfg, torch.from_numpy(keys)).numpy() == 0]
    keys = mine[:N]
    t = Table.create(spec, device="cpu")
    empty = to_numpy(t.state)
    t, res = t.insert(keys, keys * 7)
    assert res.status.tolist() == [1] * N and not bool(res.error)
    got = to_numpy(t.state)
    assert got["depth"][0] >= 2 and got["depth"][1] == 0
    lone = T.init_table(spec.table_config(), "cpu")
    lone, lres = T.apply_batch(spec.table_config(), lone, T.OpBatch(
        kind=torch.full((N,), T.INS, dtype=torch.int32),
        key=torch.from_numpy(keys), value=torch.from_numpy(keys * 7),
        seq=torch.ones(N, dtype=torch.int32)))
    for f, x in to_numpy(lone).items():
        np.testing.assert_array_equal(got[f][0], x, err_msg=f)
        np.testing.assert_array_equal(got[f][1], empty[f][1], err_msg=f)
    check_invariants(t.config, t.state)
    found, vals = t.lookup(keys)
    assert found.all() and vals.tolist() == (keys * 7).tolist()


def test_dist_check_module_passes():
    from repro_torch.core import dist_check
    assert dist_check.main(["--device", "cpu"]) == 0


def test_sharded_spec_and_facade_contract():
    spec = TableSpec(**GEOM, placement="sharded", shard_bits=2)
    cfg = spec.table_config()
    assert spec.n_shards == 4 and cfg.hash_shift == 2 and cfg.n_lanes == N
    dcfg = spec.dist_config()
    assert dcfg.n_shards == 4 and dcfg.local == cfg
    assert dcfg.local_cfg(48) == D.DistConfig(
        shard_bits=2, local=cfg).local_cfg(48)
    assert TableSpec(**GEOM).n_shards == 1
    assert TableSpec(**GEOM).table_config().hash_shift == 0
    for bits in (0, 9):
        with pytest.raises(ValueError):
            TableSpec(**GEOM, placement="sharded", shard_bits=bits)
    with pytest.raises(ValueError):
        TableSpec(**GEOM).dist_config()
    t = Table.create(spec, device="cpu")
    with pytest.raises(NotImplementedError):
        t.merge(0, 0)
    t2, res = t.apply(np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert t2 is t and res.status.shape == (0,) and res.error.ndim == 0
    # the owner shard reads the top bits of the unshifted hash
    k = torch.tensor([0, 1, -1, 2**31 - 1, -2**31 + 1], dtype=torch.int32)
    from repro_torch.core.hashing import hash_np
    want = hash_np("fmix32", k.numpy()) >> np.uint32(30)
    assert D._dest_shard(dcfg, k).tolist() == want.astype(np.int32).tolist()


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-side", sys.argv
    sys.exit(_jax_main(sys.argv[2]))
