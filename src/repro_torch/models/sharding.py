"""Logical-axis sharding helpers for the model stack: the JAX package's
``models/sharding.py`` on DTensors, with its ambient mesh (the JAX
package's ``compat.set_mesh`` / ``get_abstract_mesh``) kept here.

Meshes: single-pod ('data', 'model') = (16, 16); multi-pod
('pod', 'data', 'model') = (2, 16, 16). Batch shards over ('pod','data');
tensor/expert parallelism over 'model'. Constraints resolve a dimension to
its axis only when the axis size divides it — small archs (smollm's 9
heads, granite's 24) replicate attention while still sharding MLP/vocab.

The port's model calls none of this yet: it runs on one device, where
:func:`constrain` is the identity. The call sites come with the model on
DTensors across a mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# A spec is the counterpart of a ``PartitionSpec``: one entry per leading
# tensor dimension, each ``None`` (replicated), a mesh axis name or a tuple
# of names (e.g. the batch over ``("pod", "data")``).
Spec = Tuple[Any, ...]

_local = threading.local()


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch shards over on ``mesh``: ('pod','data'),
    ('data',) or ()."""
    return tuple(n for n in ("pod", "data") if n in mesh.mesh_dim_names)


def divides(dim: int, sizes: Dict[str, int], axis) -> bool:
    """Whether the mesh axis (or tuple of axes) ``axis`` divides ``dim``."""
    total = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        total *= sizes[a]
    return dim % total == 0


def fit_spec(sizes: Dict[str, int], shape, wanted) -> Spec:
    """Zip a wanted spec against a shape, replicating every dim its axes
    do not divide (a one-axis tuple is its axis, as in a
    ``PartitionSpec``)."""
    out = []
    for dim, ax in zip(shape, wanted):
        if ax is None or not divides(dim, sizes, ax):
            out.append(None)
        else:
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
    return tuple(out)


def placements(mesh, spec: Spec) -> List[Any]:
    """DTensor placements (one per mesh dim) for ``spec``: ``Shard(d)`` on
    every mesh axis named at tensor dim ``d``, ``Replicate()`` elsewhere. A
    dim over several axes is split in the mesh's axis order (``pod``
    outermost), as a multi-axis ``PartitionSpec`` entry is."""
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} at dim {d} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _stack():
    if not hasattr(_local, "mesh_stack"):
        _local.mesh_stack = []
    return _local.mesh_stack


def get_mesh():
    """The ambient ``DeviceMesh``, or None."""
    stk = _stack()
    return stk[-1] if stk else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the dynamic extent (this
    thread)."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None:
        return 1
    return mesh_sizes(mesh).get(name, 1)


def batch_axes() -> Optional[Tuple[str, ...]]:
    """('pod','data') when a pod axis exists, else ('data',) — or None."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return mesh_batch_axes(mesh) or None


def resolve(mesh, shape, spec_dims) -> Spec:
    """The spec ``constrain`` applies on ``mesh`` to a tensor of ``shape``:
    'batch' is resolved to ('pod','data') / ('data',), a name the mesh
    lacks to replicated, and then every dim its axes do not divide (e.g.
    'model' over smollm's 9 heads) is replicated, as :func:`fit_spec`
    does for the parameter rules."""
    sizes = mesh_sizes(mesh)
    ba = mesh_batch_axes(mesh) or None
    wanted = [ba if name == "batch" else name if name in sizes else None
              for name in spec_dims]
    return fit_spec(sizes, shape, wanted)


def constrain(x: torch.Tensor, *spec_dims):
    """``with_sharding_constraint`` that degrades gracefully: the identity
    with no ambient mesh or on a tensor that is not a DTensor; a DTensor is
    redistributed to :func:`resolve`'s spec on the ambient mesh."""
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve(mesh, x.shape, spec_dims)
    return x.redistribute(mesh, placements(mesh, spec))
