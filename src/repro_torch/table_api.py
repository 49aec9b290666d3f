"""The ``Table`` facade: one handle over the table, in PyTorch.

The paper's interface is three operations — Insert / Delete / Search —
behind one wait-free object. :class:`Table` is that object: built from a
declarative :class:`~repro_torch.core.spec.TableSpec` on one device, with
the methods

    ``lookup / insert / delete / update / apply / size / depth / merge /
    save / restore``

that accept **any batch length** (short batches are NOP-padded, long ones
run as one ``n_lanes``-wide combining transaction per chunk) and route to
the plain transaction or the CUDA kernels from **one dispatch point**
(:func:`_raw_lookup` / :func:`_raw_apply`), chosen by the spec's plan.

Writes update the table's tensors in place: a method returns a new handle,
and the handle it was called on is consumed (it shares the updated
tensors). Entry points run on ``"cuda"`` unless the caller names another
device; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import snapshot
from repro_torch.core import table as T
from repro_torch.core.spec import TableSpec
from repro_torch.core.table import (DEL, INS, NOP, BatchResult, OpBatch,
                                    from_numpy_state, resolve_device,
                                    to_numpy)
from repro_torch.kernels import ops as kops

__all__ = [
    "Table", "TableSpec", "from_numpy_state", "to_numpy",
    "NOP", "INS", "DEL", "BatchResult",
]


# ---------------------------------------------------------------------------
# backend dispatch (the one dispatch point)


def _raw_lookup(table: "Table", queries):
    """Rule-A lookup under the table's plan: ``plain`` runs
    ``table.lookup``, ``cuda`` the fused or the pre-routed probe kernel
    (``kernels/ops.py``)."""
    return kops.plan_lookup(table.plan(), table.config, table.state, queries)


def _raw_apply(table: "Table", state, ops: OpBatch):
    """One combining transaction under the table's plan: ``plain`` runs
    ``table.apply_batch``, ``cuda`` the fused or the grouped apply kernel."""
    return kops.plan_apply(table.plan(), table.config, state, ops)


# ---------------------------------------------------------------------------
# the handle


class Table:
    """Table handle: spec + device + state + the facade's seq counter."""

    __slots__ = ("spec", "device", "state", "seq")

    def __init__(self, spec: TableSpec, device: torch.device,
                 state: T.TableState, seq: int):
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "state", state)
        object.__setattr__(self, "seq", seq)

    def __setattr__(self, name, value):
        raise AttributeError("Table handles are not reassigned; methods "
                             "return new handles")

    def __repr__(self):
        return (f"Table(device={self.device}, backend={self.plan().backend}"
                f", dmax={self.spec.dmax}, n_lanes={self.spec.n_lanes})")

    @classmethod
    def create(cls, spec: TableSpec, device=None) -> "Table":
        """An empty table for ``spec`` on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        spec.plan(dev.type)         # resolves the plan for this device type
        return cls(spec, dev, T.init_table(spec.table_config(), dev), 0)

    @classmethod
    def from_state(cls, spec: TableSpec, state: T.TableState,
                   seq: int = 0) -> "Table":
        """Wrap an existing state (e.g. from :func:`from_numpy_state`)."""
        spec.plan(state.keys.device.type)
        return cls(spec, state.keys.device, state, seq)

    def _replace(self, **kw) -> "Table":
        return Table(**{s: kw.get(s, getattr(self, s))
                        for s in Table.__slots__})

    def plan(self):
        """The :class:`~repro_torch.kernels.plan.KernelPlan` this table
        dispatches with (resolved when the table was built)."""
        return self.spec.plan(self.device.type)

    @property
    def config(self) -> T.TableConfig:
        return self.spec.table_config()

    # -- reads -------------------------------------------------------------

    def lookup(self, keys):
        """Rule-A lookup, any batch length. Returns ``(found, values)``:
        bool[m] and i32[m] with -1 where absent, on the table's device."""
        q = self._i32(keys)
        if q.shape[0] == 0:
            return (torch.zeros(0, dtype=torch.bool, device=self.device),
                    torch.zeros(0, dtype=torch.int32, device=self.device))
        return _raw_lookup(self, q)

    def size(self) -> torch.Tensor:
        """Live item count (an O(pool) read of the occupancy counts)."""
        return T.table_size(self.state)

    def depth(self) -> torch.Tensor:
        """Logical directory depth."""
        return self.state.depth

    # -- updates: return (table', BatchResult) -----------------------------

    def insert(self, keys, values=None):
        """Upsert ``keys`` (any batch length); ``values`` i32[m] (default
        zeros). Status per lane: TRUE = newly inserted, FALSE = updated."""
        keys = self._i32(keys)
        return self.apply(torch.full_like(keys, INS), keys, values)

    def delete(self, keys):
        """Delete ``keys``. Status TRUE = was present."""
        keys = self._i32(keys)
        return self.apply(torch.full_like(keys, DEL), keys)

    def update(self, keys, values=None):
        """Write ``values`` only where the key is already present. Status:
        FALSE where the key was absent. Presence is read before the
        transaction; duplicate keys resolve in lane order."""
        keys = self._i32(keys)
        found, _ = self.lookup(keys)
        kinds = torch.where(found, INS, NOP).to(torch.int32)
        t2, res = self.apply(kinds, keys, values)
        status = torch.where(found, res.status, T.FALSE).to(torch.int8)
        return t2, BatchResult(status=status, error=res.error)

    def apply(self, kinds, keys, values=None):
        """Generic mixed batch of {NOP, INS, DEL} ops, any length ``m``:
        NOP-padded to whole ``n_lanes`` chunks, one combining transaction
        per chunk. Returns ``(table', BatchResult)`` with ``status[m]``."""
        kinds, keys = self._i32(kinds), self._i32(keys)
        values = (torch.zeros_like(keys) if values is None
                  else self._i32(values))
        if not (kinds.ndim == 1 and kinds.shape == keys.shape
                == values.shape):
            raise ValueError(
                f"kinds, keys and values must be matching 1-d arrays; got "
                f"{tuple(kinds.shape)}, {tuple(keys.shape)}, "
                f"{tuple(values.shape)}")
        m = kinds.shape[0]
        if m == 0:
            # empty batch: no transaction, no seq tick
            return self, BatchResult(
                status=torch.zeros(0, dtype=torch.int8, device=self.device),
                error=self.state.error)
        n = self.spec.n_lanes
        n_chunks, padded = self.spec.plan_batch(m)
        pad = padded - m
        if pad:
            kinds, keys, values = (torch.nn.functional.pad(x, (0, pad))
                                   for x in (kinds, keys, values))  # NOP=0
        state, seq, statuses = self.state, self.seq, []
        for c in range(n_chunks):
            seq += 1
            ops = OpBatch(
                kind=kinds[c * n:(c + 1) * n], key=keys[c * n:(c + 1) * n],
                value=values[c * n:(c + 1) * n],
                seq=torch.full((n,), seq, dtype=torch.int32,
                               device=self.device))
            state, res = _raw_apply(self, state, ops)
            statuses.append(res.status)
        status = torch.cat(statuses)[:m]
        return (self._replace(state=state, seq=seq),
                BatchResult(status=status, error=state.error))

    def merge(self, parent_prefix: int, parent_depth: int):
        """Merge the two buddy buckets of a would-be parent (paper §4.5).
        Returns ``(table', ok)``."""
        st, ok = T.merge_buddies(self.config, self.state, parent_prefix,
                                 parent_depth)
        return self._replace(state=st), ok

    # -- durable images (core/snapshot.py) ---------------------------------

    def save(self, path: str) -> str:
        """Serialize to a canonical, layout-independent image file, the
        JAX package's format: the items in logical-bucket order and the
        policy counters under a versioned header (host work after one copy
        of the pools). Returns ``path``."""
        return snapshot.save_table(self, path)

    @classmethod
    def restore(cls, path: str, spec: TableSpec, device=None) -> "Table":
        """Load an image (saved by either package) into a fresh table built
        for ``spec`` on ``device`` (default ``"cuda"``). ``spec`` may differ
        from the spec the image was saved under — another ``dmax``, pool,
        lane width or backend; the items re-route through the ordinary
        directory math, reactive splits included. Infeasible targets raise
        ``ValueError`` before any device work."""
        return snapshot.restore_table(path, spec, device)

    # -- helpers -----------------------------------------------------------

    def _i32(self, x) -> torch.Tensor:
        """Host or device input → int32 tensor on the table's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        # np.array copies: a 1-element view may keep a negative stride
        return torch.tensor(np.array(x, np.int32), device=self.device)
