"""Device meshes: the JAX package's ``launch/mesh.py`` as
``torch.distributed`` ``DeviceMesh``es (functions, not module constants:
importing this module starts no process group).

Production: single pod = 256 devices as (data=16, model=16); multi-pod =
512 devices as (pod=2, data=16, model=16), where the ``pod`` axis carries
only data parallelism (gradient all-reduce only, no tensor-parallel
traffic across pods).

A mesh needs a process group of at least its size. Neither function lets
``init_device_mesh`` start an ``env://`` group of its own:
:func:`make_production_mesh` needs a group that exists (a real world of
256 or 512 ranks, or the dry-run's fake world), and
:func:`make_local_mesh` starts a one-rank group itself when there is none
and the mesh has one device.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world(n: int, what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group of {n} ranks; "
                           f"start one with torch.distributed."
                           f"init_process_group")
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"{what} needs {n} ranks; the process group has "
                         f"{world}")
    return world


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the first ranks of the process
    group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _world(n, f"the {'x'.join(map(str, shape))} production mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, data: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over a process group of exactly data × model
    ranks. With no group and one device it starts a one-rank group on an
    in-process store (NCCL for ``"cuda"``, gloo otherwise); the caller
    destroys it (``torch.distributed.destroy_process_group``)."""
    n = data * model
    if not dist.is_initialized() and n == 1:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = _world(n, f"a ({data}, {model}) local mesh")
    if world != n:
        raise ValueError(f"a ({data}, {model}) local mesh needs exactly {n} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
