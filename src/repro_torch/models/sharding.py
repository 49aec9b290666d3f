"""Logical-axis sharding helpers for the model stack: the JAX package's
``models/sharding.py`` on DTensors, with its ambient mesh (the JAX
package's ``compat.set_mesh`` / ``get_abstract_mesh``) kept here.

Meshes: single-pod ('data', 'model') = (16, 16); multi-pod
('pod', 'data', 'model') = (2, 16, 16). Batch shards over ('pod','data');
tensor/expert parallelism over 'model'. Constraints resolve a dimension to
its axis only when the axis size divides it — small archs (smollm's 9
heads, granite's 24) replicate attention while still sharding MLP/vocab.

On one device, or without an ambient mesh, :func:`constrain` is the
identity and :func:`local_call` a plain call. On DTensors the model's
call sites (``layers.py``, ``ssm.py``, ``moe.py``, ``model.py``) constrain
as the JAX model does, and run what DTensor has no sharding strategy for
(sorts, index writes, the attention and scan loops) under ``local_map``
with the JAX placement at the boundary. :func:`distribute_tree` lays a
whole tree out by a spec tree and :func:`gather_tree` gathers it back.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

# A spec is the counterpart of a ``PartitionSpec``: one entry per leading
# tensor dimension, each ``None`` (replicated), a mesh axis name or a tuple
# of names (e.g. the batch over ``("pod", "data")``).
Spec = Tuple[Any, ...]

# the ambient meshes, innermost last: process-wide, not per thread, since
# the autograd engine runs the backward (and recomputes remat'd layers) on
# its own device threads
_MESHES: List[Any] = []


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


def get_mesh():
    """The ambient ``DeviceMesh``, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the dynamic extent (for every
    thread of the process: the backward runs on autograd's threads)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


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


def where(shape, *spec_dims) -> Optional[List[Any]]:
    """The placements :func:`constrain` would give a tensor of ``shape`` on
    the ambient mesh, or None without one (a ``local_map`` boundary's
    placements, spelled as a constraint)."""
    mesh = get_mesh()
    if mesh is None:
        return None
    return placements(mesh, resolve(mesh, tuple(shape), spec_dims))


def mesh_coordinate(name: str) -> int:
    """This rank's index along the ambient mesh's axis ``name`` (0 with no
    mesh or no such axis): which block of a dim sharded over ``name`` the
    local tensor inside a ``local_map`` holds."""
    mesh = get_mesh()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def is_distributed(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def place(t: torch.Tensor, like, *spec_dims):
    """A plain tensor built at its global shape (positions, masks) put on
    the mesh of ``like`` by ``spec_dims`` when ``like`` is a DTensor (each
    rank keeps its slice, no collective); else ``t``. The model builds such
    tensors on the mesh rather than letting DTensor replicate them
    implicitly."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return distribute_leaf(t, mesh, resolve(mesh, tuple(t.shape), spec_dims))


def rows_of(x: DTensor) -> List[Any]:
    """``x``'s placements with its last dim whole and no partial sum: the
    layout a function of each row (a norm, a rotation) runs on."""
    last = x.dim() - 1
    return [Replicate() if p.is_partial() or p == Shard(last) else p
            for p in x.placements]


def partial_where_split(pl):
    """The gradient placements of an input replicated beside inputs laid
    out by ``pl``: partial sums over every mesh axis that splits them (each
    rank's gradient covers its own slice), replicated over the rest."""
    return [Partial() if p.is_shard() else Replicate() for p in pl]


def local_call(fn, out_placements, in_placements, *args,
               grad_placements=None):
    """``fn(*args)`` through ``local_map`` on the ambient mesh when any
    argument is a DTensor: each DTensor argument is redistributed to its
    ``in_placements`` entry (None for a non-tensor), ``fn`` runs on the
    local tensors, and its outputs are DTensors with ``out_placements``.
    ``grad_placements`` states the placements of the inputs' gradients
    where they differ from the inputs' (a replicated input whose gradient
    each rank only partly computes is ``Partial``). With no DTensor
    argument this is ``fn(*args)``: the one-device path runs the same
    function."""
    if not is_distributed(*args):
        return fn(*args)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     device_mesh=get_mesh(), redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# whole trees on a mesh


def flatten(tree, prefix=()):
    """{path key: leaf} of nested NamedTuples and dicts, keys spelled as
    the JAX package's ``tree_flatten_with_path`` (a NamedTuple field ``f``
    as ``.f``, a dict key as itself, joined by ``/``): the checkpoints' and
    the sharding rules' leaf names."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for k, sub in items:
        out.update(flatten(sub, prefix + (k,)))
    return out


def _map_tree(fn, tree, prefix=()):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, getattr(tree, f),
                                      prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def distribute_leaf(x: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``x`` (the full tensor, on this rank's device, or a meta tensor) as a
    DTensor laid out by ``spec``: ``DTensor.from_local`` of this rank's
    slice. No collective runs; a meta tensor stays meta; a local slice
    equal to the whole tensor is ``x`` itself (the DTensor then owns it)."""
    pl = placements(mesh, spec)
    shape = tuple(x.shape)
    local_shape, offset = compute_local_shape_and_global_offset(shape, mesh,
                                                                 pl)
    if x.is_meta:
        local = torch.empty(local_shape, dtype=x.dtype, device="meta")
    elif tuple(local_shape) == shape:
        local = x
    else:
        local = x[tuple(slice(o, o + n) for o, n in
                        zip(offset, local_shape))].contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def distribute_tree(tree, specs, mesh):
    """Every leaf of ``tree`` (nested NamedTuples and dicts of full or meta
    tensors) on ``mesh`` by the spec at the same path of ``specs``
    (``launch/shardings.py``'s ``state_shardings`` / ``batch_shardings``):
    :func:`distribute_leaf`, leaf by leaf."""
    want = flatten(specs)
    return _map_tree(lambda key, x: distribute_leaf(x, mesh, want[key]),
                     tree)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its full tensor (an all-gather
    that every rank of the mesh joins); other leaves as they are."""
    return _map_tree(lambda key, x: x.full_tensor()
                     if isinstance(x, DTensor) else x, tree)
