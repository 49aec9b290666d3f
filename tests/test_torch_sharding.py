"""The PyTorch port's sharding rules, meshes and ambient-mesh constraints
against the JAX package's.

* ``launch/shardings.py``: for every arch, every train-state leaf (full
  width, through ``abstract_train_state``) and every input and decode-cache
  leaf of the four shapes, the port's spec equals the JAX
  ``state_shardings`` / ``batch_shardings`` spec on the (16, 16) and
  (2, 16, 16) production meshes, with ``attn_dshard`` both ways. The port
  side runs on ``DeviceMesh``es built over a fake process group of 512
  ranks in this process; the JAX side on a stand-in mesh (a ``.shape``
  dict), its ``NamedSharding`` replaced by the bare spec;
* ``placements``: a spec's DTensor placements, a multi-axis entry split in
  mesh order;
* ``models/sharding.py``: ``constrain`` is the identity without an ambient
  mesh, and under one resolves the same spec as the JAX ``constrain``
  (its mesh and ``with_sharding_constraint`` stood in for) and
  redistributes a DTensor to it;
* ``launch/mesh.py``: the meshes' shapes and axis names, and the loud
  failures on a missing or mis-sized process group.
"""
import dataclasses
from functools import partial

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro import compat as jcompat
from repro.configs import archs as JA
from repro.configs import shapes as JS
from repro.launch import shardings as JSH
from repro.models import sharding as JMS
from repro.training import train_step as JT
from repro_torch.configs import archs as A
from repro_torch.configs import shapes as S
from repro_torch.launch import mesh as LM
from repro_torch.launch import shardings as SH
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import sharding as MS
from repro_torch.training.checkpoint import _flat
from repro_torch.training.train_step import abstract_train_state

jax.config.update("jax_platform_name", "cpu")


class StandIn:
    """What the JAX rules read of a mesh: ``.shape`` by axis name."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.empty = False


@pytest.fixture
def meshes():
    assert not dist.is_initialized()
    fake_world(512)
    try:
        yield {False: LM.make_production_mesh(device_type="cpu"),
               True: LM.make_production_mesh(multi_pod=True,
                                             device_type="cpu")}
    finally:
        dist.destroy_process_group()


def _jax_specs(monkeypatch, fn, *args, **kw):
    """{path: spec tuple} of a JAX sharding function's output."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        fn(*args, **kw), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("arch", sorted(A.ARCHS))
def test_state_and_batch_specs_match_jax(arch, meshes, monkeypatch):
    cfg, jcfg = A.get_config(arch), JA.get_config(arch)
    state = abstract_train_state(cfg)
    jstate = jax.eval_shape(partial(JT.init_train_state, jcfg),
                            jax.random.key(0))
    for multi_pod, mesh in meshes.items():
        standin = StandIn(SH.mesh_sizes(mesh))
        assert SH.batch_axes(mesh) == JSH.batch_axes(standin)
        for dshard in (False, True):
            ours = _flat(SH.state_shardings(mesh, state, attn_dshard=dshard))
            want = _jax_specs(monkeypatch, JSH.state_shardings, standin,
                              jstate, attn_dshard=dshard)
            assert ours == want, (multi_pod, dshard)
            params = _flat(state.params)
            for key, leaf in params.items():
                assert SH.param_spec(mesh, key, tuple(leaf.shape), dshard) \
                    == tuple(JSH.param_spec(standin, key, leaf.shape,
                                            dshard)), key
        for shape in S.SHAPES:
            specs = S.input_specs(arch, shape, cfg)
            jspecs = JS.input_specs(arch, shape, jcfg)
            ours = _flat(SH.batch_shardings(mesh, specs))
            want = _jax_specs(monkeypatch, JSH.batch_shardings, standin,
                              jspecs)
            assert ours == want, (multi_pod, shape)
            if "cache" in specs:
                # the cache alone, as the dry-run lays it out
                assert _flat(SH.batch_shardings(mesh, specs["cache"])) == \
                    _jax_specs(monkeypatch, JSH.batch_shardings, standin,
                               jspecs["cache"])


def test_placements(meshes):
    m3 = meshes[True]
    assert SH.placements(m3, ()) == [Replicate()] * 3
    assert SH.placements(m3, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.placements(m3, (None, "model")) == [Replicate(), Replicate(),
                                                  Shard(1)]
    with pytest.raises(ValueError, match="order"):
        SH.placements(m3, (("data", "pod"),))


CASES = [((32, 48, 9), ("batch", None, "model")),
         ((9, 32), ("batch", "model")),
         ((64, 16, 24), (None, "model", "model")),
         ((16, 8), ("batch", "data")),
         ((48, 32), ("model", None)),
         ((32,), ("pod",))]


def test_constrain_resolves_as_jax(meshes, monkeypatch):
    x = torch.arange(12.0).reshape(3, 4)
    assert MS.constrain(x, "batch", "model") is x
    assert MS.get_mesh() is None and MS.axis_size("model") == 1
    assert MS.batch_axes() is None
    for multi_pod, mesh in meshes.items():
        standin = StandIn(SH.mesh_sizes(mesh))
        seen = []
        monkeypatch.setattr(jcompat, "get_abstract_mesh", lambda: standin)
        monkeypatch.setattr(jcompat, "with_spec_constraint",
                            lambda x, mesh, spec: seen.append(tuple(spec)))
        with MS.set_mesh(mesh):
            assert MS.get_mesh() is mesh
            assert MS.batch_axes() == JMS.batch_axes()
            assert MS.axis_size("model") == JMS.axis_size("model") == 16
            assert MS.axis_size("pod") == JMS.axis_size("pod")
            for shape, dims in CASES:
                JMS.constrain(jax.ShapeDtypeStruct(shape, "float32"), *dims)
                spec = MS.resolve(mesh, shape, dims)
                assert spec == seen[-1], (multi_pod, shape, dims)
                dt = distribute_tensor(torch.zeros(shape), mesh,
                                       [Replicate()] * mesh.ndim)
                out = MS.constrain(dt, *dims)
                assert list(out.placements) == SH.placements(mesh, spec)
                assert tuple(out.shape) == shape
                plain = torch.zeros(shape)
                assert MS.constrain(plain, *dims) is plain
        assert MS.get_mesh() is None


def test_meshes(meshes):
    m2, m3 = meshes[False], meshes[True]
    assert (m2.shape, m2.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (m3.shape, m3.mesh_dim_names) == ((2, 16, 16),
                                             ("pod", "data", "model"))
    with pytest.raises(ValueError, match="exactly 4"):
        LM.make_local_mesh(data=4, device_type="cpu")


def test_meshes_need_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_local_mesh(data=2, device_type="cpu")
    mesh = LM.make_local_mesh(device_type="cpu")
    try:
        assert (mesh.shape, mesh.mesh_dim_names) == ((1, 1),
                                                     ("data", "model"))
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
