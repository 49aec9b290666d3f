"""Sharded WF-Ext: the table split into ``2**shard_bits`` shards.

The port of ``repro/core/dist.py``. Extendible hashing gives sharding for
free: the top ``shard_bits`` of the hash select the owning shard, and each
shard runs an independent WF-Ext over the remaining bits
(``TableConfig.hash_shift`` drops the consumed prefix). The JAX package
spreads the shards over the ``model`` axis of a device mesh; here every
shard lives on the table's one device, in one process, and the two
collectives are tensor operations:

  announce  the all-gather of the op batch over ``data`` is the identity:
            every shard reads the whole announced batch;
  combine   shard j applies the full batch with every lane it does not
            own turned into a NOP, so its per-lane ``applied_seq`` /
            ``last_status`` are the JAX shard's, array for array;
  results   each lane's status comes from its owner shard (the JAX
            package's masked psum over ``model``; the masks are disjoint,
            so a select), and the error flag is any over shards.

Lookups are rule A: every shard probes the whole query batch and the owner
shard's answer is kept (a masked sum of ``found`` and of the values, -1
where a key is absent).

The state is a :class:`~repro_torch.core.table.TableState` whose every
field has a leading ``[n_shards]`` axis, like the JAX package's stacked
pytree, so ``to_numpy``, the invariants, the images and the parity tests
read both packages' states the same way. A shard's transaction runs on
views of its row of the stacked tensors: its in-place writes land there,
and every field it returns as a new tensor (``directory``, ``depth``,
``free_top``, ``applied_seq``, ``error``, ``last_status``, ...) is copied
back into its row. Shards run one after the other, one kernel launch each.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import table as T
from repro_torch.core.hashing import HASH_BITS, HASH_FNS


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Sharding of one table: ``2**shard_bits`` shards, each a WF-Ext with
    the ``local`` config."""

    shard_bits: int = 1
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


def init_dist_table(cfg: DistConfig, n_global_lanes: int,
                    device=None) -> T.TableState:
    """Empty per-shard states stacked on a leading ``[n_shards]`` axis."""
    local = T.init_table(cfg.local_cfg(n_global_lanes), device)
    return T.TableState(*(x.expand((cfg.n_shards,) + x.shape).clone()
                          for x in local))


def shard_state(state: T.TableState, j: int) -> T.TableState:
    """Shard ``j`` of a stacked state, as views of its rows."""
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
                     apply_fn=T.apply_batch):
    """One sharded combining transaction over the announced ``ops``.

    ``apply_fn(local_cfg, state, ops)`` is the per-shard transaction: the
    facade passes its plan's (``kernels/ops.py::plan_apply``, the policy
    composed onto it). ``state`` is updated in place and returned with a
    :class:`~repro_torch.core.table.BatchResult` whose ``error`` is any
    over shards."""
    lcfg = cfg.local_cfg(ops.kind.shape[0])
    dest = _dest_shard(cfg, ops.key)
    active = ops.kind != T.NOP
    status = torch.zeros_like(ops.kind, dtype=torch.int8)
    for j in range(cfg.n_shards):
        mine = (dest == j) & active
        gops = T.OpBatch(kind=torch.where(mine, ops.kind, T.NOP),
                         key=ops.key, value=ops.value, seq=ops.seq)
        view = shard_state(state, j)
        out, res = apply_fn(lcfg, view, gops)
        _write_back(state, j, view, out)
        status = torch.where(mine, res.status, status)
    return state, T.BatchResult(status=status, error=state.error.any())


def dist_lookup(cfg: DistConfig, state: T.TableState, queries,
                lookup_fn=T.lookup):
    """Rule-A sharded lookup: every shard probes the whole batch, the owner
    shard's answer is kept. Returns ``(found bool[m], values i32[m])``, -1
    where a key is absent. ``lookup_fn(local_cfg, state, queries)`` is the
    per-shard probe (the facade passes ``kernels/ops.py::plan_lookup``
    under its plan)."""
    lcfg = cfg.local_cfg(queries.shape[0])
    dest = _dest_shard(cfg, queries)
    found = torch.zeros(queries.shape, dtype=torch.bool,
                        device=queries.device)
    vals = torch.full_like(queries, -1)
    for j in range(cfg.n_shards):
        f, v = lookup_fn(lcfg, shard_state(state, j), queries)
        hit = (dest == j) & f
        found |= hit
        vals = torch.where(hit, v, vals)
    return found, vals
