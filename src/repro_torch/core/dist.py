"""Sharded WF-Ext: the table split into ``2**shard_bits`` shards.

The port of ``repro/core/dist.py``. Extendible hashing gives sharding for
free: the top ``shard_bits`` of the hash select the owning shard, and each
shard runs an independent WF-Ext over the remaining bits
(``TableConfig.hash_shift`` drops the consumed prefix). A table's shards
live in one of two placements:

* **stacked** (``mesh=None``): every shard on the table's one device, in
  one process; the collectives are tensor operations (the announce is the
  identity, the results a select of the owner shard's lanes);
* **on a mesh**: a ``torch.distributed`` ``DeviceMesh`` with the spec's
  ``data`` and ``model`` axes, one process per rank (NCCL on cards, gloo
  on the CPU). The rank at model coordinate ``m`` holds shards
  ``[m * k, (m + 1) * k)``, ``k = n_shards / model`` (the JAX package
  needs ``k == 1``; the stacked placement is the ``(1, 1)`` mesh), and
  its data coordinate ``i`` picks its slice of every batch. The body is
  JAX's ``shard_map`` body:

  announce  the rank's data slice of the op batch is all-gathered over
            the ``data`` group (one packed int32 tensor);
  combine   each local shard applies the whole announced batch with every
            lane it does not own turned into a NOP, so its per-lane
            ``applied_seq`` / ``last_status`` are the JAX shard's, array
            for array;
  results   the owner-masked int32 statuses are summed over the ``model``
            group (the masks are disjoint), the error flag is a MAX over
            it, and the rank keeps its data slice.

Lookups are rule A: every shard probes the whole query batch and the owner
shard's answer is kept (a masked sum of ``found`` and of the values over
``model``, -1 where a key is absent).

Two rules keep the ranks in step. No collective runs inside ``apply_fn``
(the plan's transaction, the policy's passes, the slow path's split
rounds): those loop a rank-local number of times. And every host decision
that gates a collective reads a value every rank holds equal: a batch
length, or a result taken after the ``model`` reduction. A host timing
that a decision rests on (the router's service times and clock, the cost
model it batches by) differs from rank to rank, so it is rank 0's,
broadcast (:func:`agree`).

The state is a :class:`~repro_torch.core.table.TableState` whose every
field has a leading shard axis (``[n_shards]`` stacked, ``[k]`` on a
mesh), like the JAX package's stacked pytree, so ``to_numpy``, the
invariants, the images and the parity tests read both packages' states
the same way (:func:`gather_shards` assembles a mesh table's whole
stack). A shard's transaction runs on views of its row of the stacked
tensors: its in-place writes land there, and every field it returns as a
new tensor (``directory``, ``depth``, ``free_top``, ``applied_seq``,
``error``, ``last_status``, ...) is copied back into its row. Local
shards run one after the other, one kernel launch each.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import table as T
from repro_torch.core.hashing import HASH_BITS, HASH_FNS


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Sharding of one table: ``2**shard_bits`` shards, each a WF-Ext with
    the ``local`` config, over a mesh's ``data_axis`` / ``model_axis``."""

    shard_bits: int = 1
    data_axis: str = "data"
    model_axis: str = "model"
    local: T.TableConfig = dataclasses.field(
        default_factory=lambda: T.TableConfig())

    @property
    def n_shards(self) -> int:
        return 1 << self.shard_bits

    def local_cfg(self, n_global_lanes: int) -> T.TableConfig:
        """The per-shard config: ``shard_bits`` hash bits shifted out, and
        the whole announced batch's width."""
        return dataclasses.replace(
            self.local, hash_shift=self.shard_bits, n_lanes=n_global_lanes)


# ---------------------------------------------------------------------------
# the mesh: coordinates, groups and the collectives


class MeshAxes(NamedTuple):
    """A rank's place on a table's mesh: each axis's size, this rank's
    coordinate on it and its process group."""

    data: int
    i: int
    data_group: object
    model: int
    m: int
    model_group: object


# read once per mesh object (a facade call would read them 3-4 times),
# keyed by identity: an equal mesh built after the process group was
# destroyed and started again has other groups
_AXES: dict = {}


def mesh_axes(cfg: DistConfig, mesh) -> MeshAxes:
    key = (id(mesh), cfg.data_axis, cfg.model_axis)
    hit = _AXES.get(key)
    if hit is not None and hit[0]() is mesh:
        return hit[1]
    names = tuple(mesh.mesh_dim_names or ())
    d, m = names.index(cfg.data_axis), names.index(cfg.model_axis)
    ax = MeshAxes(mesh.size(d), mesh.get_local_rank(d), mesh.get_group(d),
                  mesh.size(m), mesh.get_local_rank(m), mesh.get_group(m))
    _AXES[key] = (weakref.ref(mesh), ax)
    return ax


def local_shards(cfg: DistConfig, mesh) -> range:
    """The global ids of the shards this rank holds, in its rows' order."""
    if mesh is None:
        return range(cfg.n_shards)
    ax = mesh_axes(cfg, mesh)
    k = cfg.n_shards // ax.model
    return range(ax.m * k, (ax.m + 1) * k)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` (equal shapes), stacked on a new
    leading axis in the group's order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, x, group=group)
    return out.view((n,) + tuple(x.shape))


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced in place over ``group`` with ``op``."""
    dist.all_reduce(x, op=op, group=group)
    return x


def _gather_lanes(cols: torch.Tensor, group) -> torch.Tensor:
    """Columns ``[c, n_loc]`` of every rank of ``group`` joined lane-wise
    into ``[c, size * n_loc]``, rank 0's lanes first: one collective."""
    g = _all_gather(cols, group)                     # [size, c, n_loc]
    return g.transpose(0, 1).reshape(cols.shape[0], -1)


def data_slice(cfg: DistConfig, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of a global batch along its first axis (the
    ``P(data)`` block it would hold in the JAX package); the whole batch
    off a mesh."""
    if mesh is None:
        return x
    ax = mesh_axes(cfg, mesh)
    n = x.shape[0] // ax.data
    return x[ax.i * n:(ax.i + 1) * n]


def gather_data(cfg: DistConfig, mesh, *cols: torch.Tensor):
    """The global batch of each rank-sliced int32 column, on every rank:
    one all-gather over the ``data`` group (reading a ``P(data)`` array in
    the JAX package). Off a mesh the columns come back as they are."""
    if mesh is None:
        return cols
    g = _gather_lanes(torch.stack(cols), mesh_axes(cfg, mesh).data_group)
    return tuple(g)


def reduce_model(cfg: DistConfig, x: torch.Tensor, mesh,
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ``model`` group (the ranks holding the other
    shards); ``x`` itself off a mesh."""
    if mesh is None:
        return x
    return _all_reduce(x.clone(), op, mesh_axes(cfg, mesh).model_group)


def agree(values, mesh) -> list:
    """Global rank 0's ``values`` (floats: host timings, a fitted model)
    on every rank of ``mesh``'s run: one float64 broadcast over the
    process group, a CUDA tensor under NCCL. Host decisions that rest on
    them then come out equal on every rank. ``values`` themselves off a
    mesh."""
    if mesh is None:
        return list(values)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    x = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.broadcast(x, src=0)
    return x.tolist()


def gather_shards(cfg: DistConfig, state: T.TableState, mesh,
                  fields=T.TableState._fields) -> dict:
    """``{field: [n_shards, ...]}`` of the whole stacked state: each
    field's local rows all-gathered over the ``model`` group, one
    collective a field (the state's own fields off a mesh)."""
    if mesh is None:
        return {f: getattr(state, f) for f in fields}
    group = mesh_axes(cfg, mesh).model_group
    out = {}
    for f in fields:
        x = getattr(state, f)
        out[f] = _all_gather(x, group).reshape((-1,) + tuple(x.shape[1:]))
    return out


# ---------------------------------------------------------------------------
# the sharded table


def init_dist_table(cfg: DistConfig, n_global_lanes: int, device=None,
                    mesh=None) -> T.TableState:
    """Empty per-shard states stacked on a leading shard axis: all
    ``n_shards`` of them, or on a mesh this rank's ``n_shards / model``."""
    local = T.init_table(cfg.local_cfg(n_global_lanes), device)
    k = len(local_shards(cfg, mesh))
    return T.TableState(*(x.expand((k,) + x.shape).clone() for x in local))


def shard_state(state: T.TableState, j: int) -> T.TableState:
    """Row ``j`` of a stacked state, as views of its rows."""
    return T.TableState(*(x[j] for x in state))


def _write_back(state: T.TableState, j: int, view: T.TableState,
                out: T.TableState) -> None:
    """Copy every field of ``out`` that is not the view itself into row
    ``j`` of the stacked ``state`` (the in-place writes are there already)."""
    for dst, old, new in zip(state, view, out):
        if new is not old:
            dst[j].copy_(new)


def _dest_shard(cfg: DistConfig, keys: torch.Tensor) -> torch.Tensor:
    """Owner shard of each key: the top ``shard_bits`` of the unshifted
    32-bit hash (carried as int64 in [0, 2**32), so no sign extends)."""
    h = HASH_FNS[cfg.local.hash_name](keys)
    return (h >> (HASH_BITS - cfg.shard_bits)).to(torch.int32)


def dist_apply_batch(cfg: DistConfig, state: T.TableState, ops: T.OpBatch,
                     apply_fn=T.apply_batch, mesh=None):
    """One sharded combining transaction.

    Off a mesh ``ops`` is the whole announced batch and ``state`` the full
    stack. On ``mesh`` ``ops`` is this rank's data slice and ``state`` its
    local shards; the announce all-gathers the slices over the ``data``
    group, the statuses are summed and the error flag MAX-reduced over the
    ``model`` group, and the returned statuses are the rank's slice.
    ``apply_fn(local_cfg, state, ops)`` is the per-shard transaction (the
    facade passes its plan's, ``kernels/ops.py::plan_apply``, the policy
    composed onto it); it runs no collective. ``state`` is updated in
    place and returned with a :class:`~repro_torch.core.table.BatchResult`
    whose ``error`` is any over all shards."""
    ax = None if mesh is None else mesh_axes(cfg, mesh)
    n_loc = ops.kind.shape[0]
    if ax is not None:
        ops = T.OpBatch(*_gather_lanes(torch.stack(ops), ax.data_group))
    lcfg = cfg.local_cfg(ops.kind.shape[0])
    dest = _dest_shard(cfg, ops.key)
    active = ops.kind != T.NOP
    status = torch.zeros_like(ops.kind, dtype=torch.int8)
    for r, j in enumerate(local_shards(cfg, mesh)):
        mine = (dest == j) & active
        gops = T.OpBatch(kind=torch.where(mine, ops.kind, T.NOP),
                         key=ops.key, value=ops.value, seq=ops.seq)
        view = shard_state(state, r)
        out, res = apply_fn(lcfg, view, gops)
        _write_back(state, r, view, out)
        status = torch.where(mine, res.status, status)
    error = state.error.any()
    if ax is not None:
        status = _all_reduce(status.to(torch.int32), dist.ReduceOp.SUM,
                             ax.model_group)
        status = status[ax.i * n_loc:(ax.i + 1) * n_loc].to(torch.int8)
        error = _all_reduce(error.to(torch.int32).reshape(1),
                            dist.ReduceOp.MAX, ax.model_group)[0] > 0
    return state, T.BatchResult(status=status, error=error)


def dist_lookup(cfg: DistConfig, state: T.TableState, queries,
                lookup_fn=T.lookup, mesh=None):
    """Rule-A sharded lookup: every shard probes the whole batch, the owner
    shard's answer is kept. Returns ``(found bool[m], values i32[m])``, -1
    where a key is absent. On ``mesh`` ``queries`` is this rank's data
    slice, all-gathered over the ``data`` group; ``found`` and the
    found-masked values are summed in int32 over the ``model`` group (one
    collective) and the rank keeps its slice. ``lookup_fn(local_cfg,
    state, queries)`` is the per-shard probe (the facade passes
    ``kernels/ops.py::plan_lookup`` under its plan)."""
    ax = None if mesh is None else mesh_axes(cfg, mesh)
    n_loc = queries.shape[0]
    if ax is not None:
        queries = _all_gather(queries, ax.data_group).reshape(-1)
    lcfg = cfg.local_cfg(queries.shape[0])
    dest = _dest_shard(cfg, queries)
    found = torch.zeros(queries.shape, dtype=torch.bool,
                        device=queries.device)
    vals = torch.full_like(queries, -1)
    for r, j in enumerate(local_shards(cfg, mesh)):
        f, v = lookup_fn(lcfg, shard_state(state, r), queries)
        hit = (dest == j) & f
        found |= hit
        vals = torch.where(hit, v, vals)
    if ax is not None:
        both = torch.stack([found.to(torch.int32),
                            torch.where(found, vals, 0)])
        both = _all_reduce(both, dist.ReduceOp.SUM, ax.model_group)
        both = both[:, ax.i * n_loc:(ax.i + 1) * n_loc]
        found = both[0] > 0
        vals = torch.where(found, both[1], -1)
    return found, vals
