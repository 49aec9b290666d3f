"""The PyTorch port's sharded table on a device mesh of gloo ranks against
the JAX package's sharded table and against the port's stacked placement.

Seven processes of this file, joined through ``FileStore``s (no TCP
port), run once per test session in its temporary root, beside the JAX
subprocess of ``tests/test_torch_dist.py`` (its ``.npz`` is shared, not
recomputed):
a world of one rank holds a ``(1, 1)`` ``("data", "model")`` mesh, a world
of two the meshes ``(1, 2)`` and ``(2, 1)``, a world of four ``(2, 2)`` and
``(1, 4)``. That covers one shard per rank, data replicas, and two shards
per rank. On each mesh every rank drives the streams of ``raw2``,
``policy4`` and ``schema2`` (``policy4`` alone on ``(1, 4)``) through
``Table.create(spec, mesh=...)`` with the global batch, and writes what it
reads back: statuses, lookups, the whole stacked state gathered over
``model`` (``invariants.full_view``), images, payloads, slabs, ``size`` /
``depth`` / ``policy_stats``. Each must equal the JAX arrays array for
array (per-shard trash rows excepted) on every rank, and the ``(1, 1)``
mesh must equal the stacked path bit for bit.

The four-rank world also saves ``policy4``'s 4-shard table from ``(1, 4)``
and restores it onto ``(2, 2)`` as a 2-shard table; the same file restores
here onto one device. It replays ``snapshot_restore`` (re-sharding 2 → 4
at its revives) on ``(2, 2)``, and checks each mesh validation error.
``dist_check --data 2 --model 2`` runs on four more gloo ranks.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_dist import (CASES, GEOM, payload, port_spec, run_port,
                             session_path, shared_jax_run, steps)

HERE = os.path.abspath(__file__)
SRC = os.path.abspath(os.path.join(os.path.dirname(HERE), "..", "src"))
# world size -> the meshes (data, model) its ranks build, in order
WORLDS = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
RUNS = [(name, shape) for w in WORLDS for shape in WORLDS[w]
        for name in sorted(CASES)
        if (1 << CASES[name][0]) % shape[1] == 0]
REPLAY = "snapshot_restore"
REPLAY_SCALE = 0.25
VALIDATION = ("local_spec", "missing_axis", "model_divides_shards",
              "data_divides_lanes", "world", "device_type")


def mesh_name(shape):
    return f"{shape[0]}x{shape[1]}"


# ---------------------------------------------------------------------------
# the ranks (subprocesses of this file)


def drive(name, mesh):
    """The case's stream through a mesh table; every result is global."""
    from repro_torch.core.invariants import check_invariants, full_view
    from repro_torch.core.snapshot import extract_image
    from repro_torch.table_api import Table

    spec = port_spec(name)
    t = Table.create(spec, device="cpu", mesh=mesh)
    statuses, found, vals = [], [], []
    for kinds, keys, v, q in steps(name):
        values = payload(keys, v) if spec.value_schema else v
        t, res = t.apply(kinds, keys, values)
        statuses.append(res.status.numpy())
        f, got = t.lookup(q)
        found.append(f.numpy())
        vals.append((got["page"] if spec.value_schema else got).numpy())
    out = {"status": np.stack(statuses), "found": np.stack(found),
           "vals": np.stack(vals)}
    full = full_view(t)
    check_invariants(t.config, t.state)         # the local shards
    check_invariants(t.config, full)
    out.update({f"state__{f}": x for f, x in full.items()})
    st = t.policy_stats()
    out["stats"] = np.asarray([int(t.size()), int(t.depth()),
                               int(st["splits"]), int(st["merges"])])
    out["pressure"] = np.asarray(float(st["pressure"]))
    out["local_shards"] = np.asarray(t.state.keys.shape[0])
    img = extract_image(t)
    out["image_keys"] = img.keys
    if spec.value_schema:
        for f in ("page", "score"):
            out[f"image_{f}"] = img.values[f]
            out[f"slab_{f}"] = t.slabs[f].numpy()
        out["slab_live"] = t.slab_live.numpy()
    else:
        out["image_vals"] = img.values
    return t, out


def validation_errors():
    """Each mesh validation case on this four-rank world: the message of
    the ``ValueError`` it raises (or ``None``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.table_api import Table, TableSpec

    sharded = dict(GEOM, placement="sharded", shard_bits=1)
    mesh22 = make_local_mesh(data=2, model=2, device_type="cpu")
    cases = {
        "local_spec": lambda: Table.create(TableSpec(**GEOM), "cpu", mesh22),
        "missing_axis": lambda: Table.create(
            TableSpec(**sharded), "cpu", init_device_mesh(
                "cpu", (2, 2), mesh_dim_names=("data", "tensor"))),
        "model_divides_shards": lambda: Table.create(
            TableSpec(**sharded), "cpu", make_local_mesh(
                data=1, model=4, device_type="cpu")),
        "data_divides_lanes": lambda: Table.create(
            TableSpec(**dict(sharded, n_lanes=7)), "cpu", mesh22),
        # a mesh over half of the process group's ranks
        "world": lambda: Table.create(TableSpec(**sharded), "cpu",
                                      _half_mesh()),
        "device_type": lambda: Table.create(TableSpec(**sharded), "meta",
                                            mesh22),
    }
    out = {}
    for what in VALIDATION:
        try:
            cases[what]()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def _half_mesh():
    """A ``(1, 2)`` mesh over ranks 0-1 of a larger process group."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                      mesh_dim_names=("data", "model"))


def _rank_main(rank, world, tmp):
    import torch.distributed as dist

    from repro_torch.core.snapshot import extract_image
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.table_api import Table, TableSpec
    from repro_torch.workloads import get_scenario, replay

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"store{world}"), world), rank=rank,
        world_size=world)
    try:
        out, tables = {}, {}
        for shape in WORLDS[world]:
            mesh = make_local_mesh(data=shape[0], model=shape[1],
                                   device_type="cpu")
            for name, s in RUNS:
                if s != shape:
                    continue
                tables[name, shape], got = drive(name, mesh)
                for k, v in got.items():
                    out[f"{name}|{mesh_name(shape)}|{k}"] = v
        if world == 4:
            # policy4's 4-shard table saved from (1, 4), restored onto
            # (2, 2) as a 2-shard table
            path = os.path.join(tmp, "policy4_1x4.npz")
            assert tables["policy4", (1, 4)].save(path) == path
            assert os.path.exists(path)         # behind the barrier
            mesh22 = make_local_mesh(data=2, model=2, device_type="cpu")
            spec2 = dataclasses.replace(port_spec("policy4"), shard_bits=1,
                                        dmax=GEOM["dmax"] + 1,
                                        pool_size=2 * GEOM["pool_size"])
            back = Table.restore(path, spec2, "cpu", mesh22)
            img = extract_image(back)
            out["restored_2x2|image_keys"] = img.keys
            out["restored_2x2|image_vals"] = img.values
            out["restored_2x2|local_shards"] = np.asarray(
                back.state.keys.shape[0])
            from repro_torch.core.invariants import full_view, to_dict
            full = full_view(back)
            out["restored_2x2|items"] = np.asarray(
                sorted(to_dict(back.config, full).items()), np.int64)
            out["restored_2x2|stats"] = np.asarray(
                [int(x) for x in back.policy_stats().values()][:2])

            spec, trace = get_scenario(REPLAY, placement="sharded",
                                       scale=REPLAY_SCALE)
            target = dataclasses.replace(spec, shard_bits=2, dmax=8)
            rep = replay(spec, trace, device="cpu", oracle="both",
                         raise_on_mismatch=False, restore_spec=target,
                         mesh=mesh22)
            out["replay"] = np.frombuffer(json.dumps(
                rep, sort_keys=True, default=lambda o: o.item()).encode(),
                np.uint8)
            out["validation"] = np.frombuffer(json.dumps(
                validation_errors()).encode(), np.uint8)
        if world == 1:
            # a process group destroyed and started again: an equal mesh
            # over the new group drives a table
            dist.destroy_process_group()
            dist.init_process_group("gloo", store=dist.FileStore(
                os.path.join(tmp, "store1_again"), 1), rank=0, world_size=1)
            from repro_torch.core.dist import mesh_axes
            mesh = make_local_mesh(device_type="cpu")
            t = Table.create(port_spec("raw2"), "cpu", mesh)
            keys = np.arange(1, 40, dtype=np.int32)
            t, res = t.insert(keys, keys)
            out["again|status"] = res.status.numpy()
            out["again|size"] = np.asarray(int(t.size()))
            ax = mesh_axes(t.spec.dist_config(), mesh)
            out["again|new_groups"] = np.asarray(
                ax.data_group is mesh.get_group("data")
                and ax.model_group is mesh.get_group("model"))
        np.savez(os.path.join(tmp, f"w{world}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the fixtures


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{world: [each rank's results]} from the seven ranks, which run once
    per test session, and the directory of their files."""
    tmp = session_path(tmp_path_factory, "mesh_table", _start_ranks)
    runs = {}
    for w in WORLDS:
        runs[w] = []
        for r in range(w):
            with np.load(os.path.join(tmp, f"w{w}_r{r}.npz")) as z:
                runs[w].append(dict(z))
    return runs, tmp


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return shared_jax_run(tmp_path_factory)


def _start_ranks(path):
    part = path + ".part"
    os.makedirs(part, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(r), str(w), part], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for w in WORLDS for r in range(w)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (p.args, out[-2000:], err[-4000:])
    os.replace(part, path)


def world_of(shape):
    return shape[0] * shape[1]


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("name,shape", RUNS,
                         ids=[f"{n}-{mesh_name(s)}" for n, s in RUNS])
def test_mesh_table_matches_jax(mesh_runs, jax_run, name, shape):
    runs, _ = mesh_runs
    ranks = runs[world_of(shape)]
    p = f"{name}|{mesh_name(shape)}|"
    got = {k[len(p):]: v for k, v in ranks[0].items() if k.startswith(p)}
    for other in ranks[1:]:                 # every rank reads the same
        for k, v in got.items():
            if k != "local_shards":
                np.testing.assert_array_equal(other[p + k], v, err_msg=k)
    assert int(got["local_shards"]) == (1 << CASES[name][0]) // shape[1]
    for k in ("status", "found", "vals", "stats", "pressure",
              "image_keys"):
        want = jax_run[f"{name}__{k}"]
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    P = GEOM["pool_size"]
    for f in (k for k in got if k.startswith("state__")):
        x, y = got[f], jax_run[f"{name}__{f}"]
        assert x.shape == y.shape, f
        if x.ndim >= 2 and x.shape[1] == P + 1:
            x, y = x[:, :P], y[:, :P]       # the per-shard trash rows
        np.testing.assert_array_equal(x, y, err_msg=f)
    if port_spec(name).value_schema is None:
        np.testing.assert_array_equal(got["image_vals"],
                                      jax_run[f"{name}__image_vals"])
    else:
        for k in ("image_page", "image_score", "slab_page", "slab_score",
                  "slab_live"):
            np.testing.assert_array_equal(got[k], jax_run[f"{name}__{k}"],
                                          err_msg=k)
    assert not got["state__error"].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_rank_mesh_equals_stacked(mesh_runs, name):
    """The ``(1, 1)`` mesh against the stacked placement: statuses,
    lookups and every state array, trash rows included, bit for bit."""
    from repro_torch.table_api import to_numpy
    runs, _ = mesh_runs
    got = runs[1][0]
    p = f"{name}|1x1|"
    t, status, found, vals = run_port(name)
    np.testing.assert_array_equal(got[p + "status"], status)
    np.testing.assert_array_equal(got[p + "found"], found)
    np.testing.assert_array_equal(got[p + "vals"], vals)
    for f, x in to_numpy(t.state).items():
        np.testing.assert_array_equal(got[p + "state__" + f], x, err_msg=f)
    assert int(got[p + "local_shards"]) == t.spec.n_shards


def test_mesh_after_the_process_group_restarts(mesh_runs):
    """After ``destroy_process_group`` and a new group, an equal ``(1, 1)``
    mesh (``DeviceMesh`` compares by layout) drives a table through the
    new mesh's groups, not the destroyed ones."""
    runs, _ = mesh_runs
    got = runs[1][0]
    assert bool(got["again|new_groups"])
    assert got["again|status"].tolist() == [1] * 39
    assert int(got["again|size"]) == 39


# ---------------------------------------------------------------------------
# snapshots, replay and dist_check on meshes


def test_snapshot_reshards_across_meshes_and_onto_one_device(mesh_runs,
                                                              jax_run):
    """``policy4``'s image saved on ``(1, 4)`` (rank 0 writes it) restores
    onto ``(2, 2)`` as a 2-shard table, 1 shard a rank, and here onto one
    device, stacked and local: every canonical image equals the JAX
    table's, and the content equals ``SeqExtHash`` holding the image's
    items at the aggregate ``dmax + shard_bits`` bits."""
    from repro_torch.core.invariants import check_invariants, to_dict
    from repro_torch.core.reference import SeqExtHash
    from repro_torch.core.snapshot import extract_image
    from repro_torch.table_api import Table, TableSpec

    runs, tmp = mesh_runs
    keys, vals = (jax_run["policy4__image_keys"],
                  jax_run["policy4__image_vals"])
    ref = SeqExtHash(dmax=GEOM["dmax"] + 2, bucket_size=GEOM["bucket_size"])
    for k, v in zip(keys.tolist(), vals.tolist()):
        assert ref.insert(k, v) == 1
    want = sorted(ref.as_dict().items())
    for r, got in enumerate(runs[4]):
        assert int(got["restored_2x2|local_shards"]) == 1, r
        np.testing.assert_array_equal(got["restored_2x2|image_keys"], keys)
        np.testing.assert_array_equal(got["restored_2x2|image_vals"], vals)
        assert got["restored_2x2|items"].tolist() == [list(x) for x in want]
        # the header's policy counters, reinstalled on shard 0
        assert got["restored_2x2|stats"].tolist() == \
            jax_run["policy4__stats"][2:].tolist()
    path = os.path.join(tmp, "policy4_1x4.npz")
    for spec in (TableSpec(**dict(GEOM, dmax=9, pool_size=512),
                           placement="sharded", shard_bits=1),
                 TableSpec(**dict(GEOM, dmax=10, pool_size=1024))):
        t = Table.restore(path, spec, device="cpu")
        img = extract_image(t)
        np.testing.assert_array_equal(img.keys, keys)
        np.testing.assert_array_equal(img.values, vals)
        check_invariants(t.config, t.state)
        assert sorted(to_dict(t.config, t.state).items()) == want


def test_replay_on_a_mesh_equals_the_stacked_replay(mesh_runs):
    """``snapshot_restore`` on ``(2, 2)``, its revives re-sharding 2 → 4
    on the mesh: no mismatch against both oracles, and the summary of the
    stacked replay of the same trace (depth trajectory, policy counters,
    phases)."""
    from test_torch_workloads import _plain, _summary

    from repro_torch.workloads import get_scenario, replay
    runs, _ = mesh_runs
    reps = [json.loads(bytes(r["replay"]).decode()) for r in runs[4]]
    for rep in reps:
        assert rep["ok"], (rep["status_mismatches"],
                           rep["content_mismatches"],
                           rep["mismatch_examples"])
        assert rep["snapshot_restores"] == 2
        assert _summary(rep) == _summary(reps[0])
    spec, trace = get_scenario(REPLAY, placement="sharded",
                               scale=REPLAY_SCALE)
    target = dataclasses.replace(spec, shard_bits=2, dmax=8)
    stacked = replay(spec, trace, device="cpu", oracle="both",
                     raise_on_mismatch=False, restore_spec=target)
    assert stacked["ok"]
    assert _plain(_summary(reps[0])) == _plain(_summary(stacked))
    assert reps[0]["policy"]["splits"] > 0


def test_dist_check_on_a_mesh(tmp_path):
    """``python -m repro_torch.core.dist_check --device cpu --data 2
    --model 2`` on four gloo ranks joined through a file: exit 0, rank 0
    prints the 2- and 4-shard lines and the compression line."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               WORLD_SIZE="4")
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.core.dist_check", "--device",
         "cpu", "--data", "2", "--model", "2", "--dist-init", init],
        env=dict(env, RANK=str(r)), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (out[-2000:], err[-4000:])
        outs.append(out)
    lines = outs[0].splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "dist table OK", "dist table OK", "compression OK"], lines
    assert "across 2 shards on a (2, 2) mesh" in lines[0]
    assert "across 4 shards on a (2, 2) mesh" in lines[1]
    assert not any(o.strip() for o in outs[1:])


# ---------------------------------------------------------------------------
# validation


@pytest.mark.parametrize("what", VALIDATION)
def test_mesh_validation_raises(mesh_runs, what):
    """A local spec on a mesh, a mesh lacking the spec's ``model`` axis, a
    ``model`` axis that does not divide ``n_shards``, a ``data`` axis that
    does not divide ``n_lanes``, a mesh that spans half the process group,
    and a device of another type than the mesh's: each a ``ValueError``,
    on every rank."""
    runs, _ = mesh_runs
    want = {"local_spec": "placement='sharded'",
            "missing_axis": "not 'model'",
            "model_divides_shards": "does not divide n_shards",
            "data_divides_lanes": "does not divide n_lanes",
            "world": "the process group has 4",
            "device_type": "cannot hold a table on meta"}[what]
    for r in runs[4]:
        msg = json.loads(bytes(r["validation"]).decode())[what]
        assert msg is not None and want in msg, msg


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
