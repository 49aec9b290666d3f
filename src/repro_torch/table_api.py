"""The ``Table`` facade: one handle over the table, in PyTorch.

The paper's interface is three operations — Insert / Delete / Search —
behind one wait-free object. :class:`Table` is that object: built from a
declarative :class:`~repro_torch.core.spec.TableSpec` on one device, with
the methods

    ``lookup / insert / delete / update / apply / size / depth / merge /
    policy_stats / save / restore``

that accept **any batch length** (short batches are NOP-padded, long ones
run as one ``n_lanes``-wide combining transaction per chunk) and route to
the plain transaction or the CUDA kernels, locally or per shard
(``core/dist.py``), from **one dispatch point** (:func:`_raw_lookup` /
:func:`_raw_apply`), chosen by the spec's plan and placement. A spec's
``resize_policy`` composes onto the transaction there (per shard for
sharded placement). A sharded table keeps its shards stacked on a leading
axis, all of them on its one device, or, built with a ``mesh``, spread
over the mesh's ``model`` axis, one process per rank.

A mesh table
------------
``Table.create(spec, mesh=mesh)`` lays a sharded table out on a
``torch.distributed`` ``DeviceMesh`` with the spec's ``data_axis`` and
``model_axis`` (``launch/mesh.py::make_local_mesh``): the rank at model
coordinate ``m`` holds shards ``[m * k, (m + 1) * k)`` of ``k = n_shards /
model``. Every rank calls every method with the same global batch, as the
JAX package's single controller does; the rank's data coordinate picks its
slice, ``core/dist.py`` announces the slices and reduces the results over
the mesh, and every method returns the global result on every rank (an
all-gather of the data slices over ``data``). ``size``, ``depth`` and
``policy_stats`` are totals over the ``model`` group. Slabs and their
liveness are replicated: every rank computes them from the same global
results. The ranks must make every call in the same order.

Value schemas (struct-of-slabs side store)
------------------------------------------
When ``spec.value_schema`` is set, each item's payload is a dict of fields
living in per-field slab tensors ``[slab_rows + 1, *field_shape]``. The
core table keeps storing one i32 word per key, and that word is a
**handle**: a stable row index into the slabs. Handles are allocated from a
liveness bitmap at insert (the lowest free rows, in the order of each new
key's first lane), travel with their key through splits, merges and
directory doubling (which therefore never touch payloads), and are freed by
delete. After every transaction the liveness is reconciled against a
post-transaction lookup of the batch keys: whatever handle the table maps a
key to afterwards is live, every other handle the batch touched is free.
The handles are the JAX package's, so both packages hold the same value
words in every state.

Writes update the table's tensors in place: a method returns a new handle,
and the handle it was called on is consumed (it shares the updated
tensors). Entry points run on ``"cuda"`` unless the caller names another
device; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.core import dist as D
from repro_torch.core import snapshot
from repro_torch.core import table as T
from repro_torch.core.policy import ResizePolicy, policy_stats, wrap_apply_fn
from repro_torch.core.spec import (TableSpec, ValueField, signed_view,
                                   torch_dtype)
from repro_torch.core.table import (DEL, INS, NOP, BatchResult, OpBatch,
                                    from_numpy_state, resolve_device,
                                    to_numpy)
from repro_torch.kernels import ops as kops

__all__ = [
    "Table", "TableSpec", "ValueField", "ResizePolicy", "create",
    "from_numpy_state", "to_numpy", "NOP", "INS", "DEL", "BatchResult",
]


# ---------------------------------------------------------------------------
# backend dispatch (the one dispatch point)


def _raw_lookup(table: "Table", state, queries):
    """Rule-A lookup of the i32 words under the table's plan: ``plain``
    runs ``table.lookup``, ``cuda`` the fused or the pre-routed probe
    kernel (``kernels/ops.py``); per shard for sharded placement (on a
    mesh: the rank's data slice in, the global result out)."""
    lookup_fn = functools.partial(kops.plan_lookup, table.plan())
    if table.spec.placement == "sharded":
        dcfg, mesh = table.spec.dist_config(), table.mesh
        found, word = D.dist_lookup(dcfg, state,
                                    D.data_slice(dcfg, queries, mesh),
                                    lookup_fn=lookup_fn, mesh=mesh)
        if mesh is None:
            return found, word
        found, word = D.gather_data(dcfg, mesh, found.to(torch.int32), word)
        return found > 0, word
    return lookup_fn(table.config, state, queries)


def _raw_apply(table: "Table", state, ops: OpBatch):
    """One combining transaction under the table's plan: ``plain`` runs
    ``table.apply_batch``, ``cuda`` the fused or the grouped apply kernel;
    per shard for sharded placement. ``spec.resize_policy`` composes onto
    it here: the policy's split and merge passes run right after each
    transaction, on each shard's own state. On a mesh the rank's data
    slice of ``ops`` goes in and the global statuses come out."""
    apply_fn = functools.partial(kops.plan_apply, table.plan())
    if table.spec.resize_policy is not None:
        apply_fn = wrap_apply_fn(table.spec.resize_policy, apply_fn)
    if table.spec.placement == "sharded":
        dcfg, mesh = table.spec.dist_config(), table.mesh
        mine = OpBatch(*(D.data_slice(dcfg, x, mesh) for x in ops))
        state, res = D.dist_apply_batch(dcfg, state, mine,
                                        apply_fn=apply_fn, mesh=mesh)
        if mesh is not None:
            status, = D.gather_data(dcfg, mesh, res.status.to(torch.int32))
            res = res._replace(status=status.to(torch.int8))
        return state, res
    return apply_fn(table.config, state, ops)


# ---------------------------------------------------------------------------
# the handle


class Table:
    """Table handle: spec + device + state + (schema mode) payload slabs
    and their liveness bitmap + the facade's seq counter + the mesh of a
    mesh table (None on one device)."""

    __slots__ = ("spec", "device", "state", "slabs", "slab_live", "seq",
                 "mesh")

    def __init__(self, spec: TableSpec, device: torch.device,
                 state: T.TableState, slabs, slab_live, seq: int,
                 mesh=None):
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "state", state)
        object.__setattr__(self, "slabs", slabs)
        object.__setattr__(self, "slab_live", slab_live)
        object.__setattr__(self, "seq", seq)
        object.__setattr__(self, "mesh", mesh)

    def __setattr__(self, name, value):
        raise AttributeError("Table handles are not reassigned; methods "
                             "return new handles")

    def __repr__(self):
        fields = (tuple(f.name for f in self.spec.value_schema)
                  if self.spec.value_schema else "i32")
        return (f"Table(device={self.device}, backend={self.plan().backend}"
                f", dmax={self.spec.dmax}, n_lanes={self.spec.n_lanes}, "
                f"values={fields})")

    @classmethod
    def create(cls, spec: TableSpec, device=None, mesh=None) -> "Table":
        """An empty table for ``spec`` on ``device`` (default ``"cuda"``).
        A sharded spec's shards all go on ``device``, or with ``mesh`` (a
        ``DeviceMesh``, see :meth:`TableSpec.check_mesh`) this rank's
        shards go on its device of the mesh's type (``cuda`` is the
        current device); every rank of the mesh calls this."""
        dev = _mesh_device(spec, device, mesh)
        if spec.placement == "sharded":
            return cls._wrap(spec, D.init_dist_table(
                spec.dist_config(), spec.n_lanes, dev, mesh), mesh=mesh)
        return cls._wrap(spec, T.init_table(spec.table_config(), dev))

    @classmethod
    def from_state(cls, spec: TableSpec, state: T.TableState, seq: int = 0,
                   slabs=None, slab_live=None, mesh=None) -> "Table":
        """Wrap an existing state (e.g. from :func:`from_numpy_state`). In
        schema mode ``slabs`` / ``slab_live`` default to an empty side
        store (row ``slab_rows``, the trash row, is born live). With
        ``mesh``, ``state`` is a whole stacked sharded state and the table
        keeps this rank's rows of it (views: the JAX package's
        ``device_put`` with ``P(model)``); every rank calls this."""
        if mesh is not None:
            _mesh_device(spec, state.keys.device, mesh)
            if state.keys.shape[0] != spec.n_shards:
                raise ValueError(f"a stacked state of {spec.n_shards} "
                                 f"shards, not {state.keys.shape[0]}")
            rows = D.local_shards(spec.dist_config(), mesh)
            state = T.TableState(*(x[rows.start:rows.stop] for x in state))
        return cls._wrap(spec, state, seq, slabs, slab_live, mesh)

    @classmethod
    def _wrap(cls, spec, state, seq=0, slabs=None, slab_live=None,
              mesh=None) -> "Table":
        """A handle on ``state`` as it is (a mesh table's local rows)."""
        dev = state.keys.device
        spec.plan(dev.type)         # resolves the plan for this device type
        if spec.value_schema is not None and slabs is None:
            cap = spec.slab_rows
            slabs = {f.name: torch.zeros((cap + 1,) + f.shape,
                                         dtype=torch_dtype(f.dtype),
                                         device=dev)
                     for f in spec.value_schema}
            slab_live = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
            slab_live[cap] = True
        return cls(spec, dev, state, slabs, slab_live, seq, mesh)

    def _replace(self, **kw) -> "Table":
        return Table(**{s: kw.get(s, getattr(self, s))
                        for s in Table.__slots__})

    def plan(self):
        """The :class:`~repro_torch.kernels.plan.KernelPlan` this table
        dispatches with (resolved when the table was built)."""
        return self.spec.plan(self.device.type)

    @property
    def config(self) -> T.TableConfig:
        """The local, or per-shard, ``TableConfig`` (tests, invariants)."""
        return self.spec.table_config()

    # -- reads -------------------------------------------------------------

    def lookup(self, keys):
        """Rule-A lookup, any batch length. Returns ``(found, values)``:
        bool[m], and the payload dict (zeros where absent) in schema mode
        or the i32 word (-1 where absent), on the table's device."""
        with telemetry.span("repro.facade.lookup"):
            q = self._i32(keys)
            m = q.shape[0]
            if m == 0:
                found = torch.zeros(0, dtype=torch.bool, device=self.device)
                word = torch.zeros(0, dtype=torch.int32, device=self.device)
            else:
                if self.spec.placement == "sharded":
                    # a whole number of n_lanes, as the JAX facade pads for
                    # its data axis
                    q = _pad(q, self.spec.plan_batch(m)[1])
                found, word = _raw_lookup(self, self.state, q)
                found, word = found[:m], word[:m]
            if self.spec.value_schema is None:
                return found, word
            cap = self.spec.slab_rows
            h = torch.where(found, word, cap).clamp(0, cap).long()
            out = {}
            for name, slab in self.slabs.items():
                leaf = signed_view(slab)[h]
                mask = found.reshape(found.shape + (1,) * (leaf.ndim - 1))
                out[name] = torch.where(mask, leaf,
                                        torch.zeros_like(leaf)).view(
                                            slab.dtype)
            return found, out

    def size(self) -> torch.Tensor:
        """Live item count (an O(pool) read of the occupancy counts; summed
        over shards)."""
        return self._total(T.table_size(self.state))

    def depth(self) -> torch.Tensor:
        """Logical directory depth (the max over shards)."""
        return self._total(self.state.depth.max(), dist.ReduceOp.MAX)

    def policy_stats(self) -> dict:
        """Cumulative elastic-policy actions and the live backpressure
        signal, as ``{"splits", "merges", "pressure"}`` device scalars.
        The counters are summed over shards; reactive overflow splits are
        not counted; ``pressure`` is
        :func:`~repro_torch.core.policy.resize_pressure`, over all shards'
        live buckets. All three are zeros when ``spec.resize_policy`` is
        None."""
        return policy_stats(self.config, self.spec.resize_policy,
                            self.state, self._total)

    def _total(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` over the whole table: reduced over a mesh table's
        ``model`` group, as it is on one device."""
        if self.mesh is None:
            return x
        return D.reduce_model(self.spec.dist_config(), x, self.mesh, op)

    def _error(self) -> torch.Tensor:
        """The error flag of any shard (bool[], the same on every rank)."""
        return self._total(self.state.error.any().to(torch.int32),
                           dist.ReduceOp.MAX) > 0

    # -- updates: return (table', BatchResult) -----------------------------

    def insert(self, keys, values=None):
        """Upsert ``keys`` (any batch length). ``values``: the schema's
        ``{field: [m, *shape]}`` dict, or i32[m] in raw mode (default
        zeros). Status per lane: TRUE = newly inserted, FALSE = updated."""
        keys = self._i32(keys)
        return self.apply(torch.full_like(keys, INS), keys, values)

    def delete(self, keys):
        """Delete ``keys``. Status TRUE = was present. Frees payload
        handles (schema mode)."""
        keys = self._i32(keys)
        return self.apply(torch.full_like(keys, DEL), keys)

    def update(self, keys, values=None):
        """Write ``values`` only where the key is already present. Status:
        FALSE where the key was absent. Presence is read before the
        transaction; duplicate keys resolve in lane order."""
        with telemetry.span("repro.facade.update"):
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
        with telemetry.span("repro.facade.apply"):
            kinds, keys = self._i32(kinds), self._i32(keys)
            if not (kinds.ndim == 1 and kinds.shape == keys.shape):
                raise ValueError(
                    f"kinds and keys must be matching 1-d arrays; got "
                    f"{tuple(kinds.shape)}, {tuple(keys.shape)}")
            m = kinds.shape[0]
            values = self._check_values(m, values)
            if m == 0:
                # empty batch: no transaction, no seq tick
                return self, BatchResult(
                    status=torch.zeros(0, dtype=torch.int8,
                                       device=self.device),
                    error=self._error())
            n = self.spec.n_lanes
            n_chunks, padded = self.spec.plan_batch(m)
            kinds, keys = _pad(kinds, padded), _pad(keys, padded)  # NOP == 0
            values = ({k: _pad(v, padded) for k, v in values.items()}
                      if isinstance(values, dict) else _pad(values, padded))
            t, statuses = self, []
            for c in range(n_chunks):
                lanes = slice(c * n, (c + 1) * n)
                chunk = ({k: v[lanes] for k, v in values.items()}
                         if isinstance(values, dict) else values[lanes])
                t, status, error = t._apply_chunk(kinds[lanes], keys[lanes],
                                                  chunk)
                statuses.append(status)
            status = torch.cat(statuses)[:m]
            # the error flag is sticky: the last chunk's covers the call
            return t, BatchResult(status=status, error=error)

    def merge(self, parent_prefix: int, parent_depth: int):
        """Merge the two buddy buckets of a would-be parent (paper §4.5).
        Local placement only. Returns ``(table', ok)``; payload handles
        travel with their keys, so the slabs are untouched."""
        if self.spec.placement != "local":
            raise NotImplementedError(
                "merge is shard-local; run it per shard (placement='local')")
        st, ok = T.merge_buddies(self.config, self.state, parent_prefix,
                                 parent_depth)
        return self._replace(state=st), ok

    # -- durable images (core/snapshot.py) ---------------------------------

    def save(self, path: str, mesh=None) -> str:
        """Serialize to a canonical, layout-independent image file, the
        JAX package's format: the items in logical-bucket order, payload
        fields resolved (schema mode), and the policy counters under a
        versioned header. Returns ``path``. A mesh table's ranks all call
        this, and global rank 0 writes the file; so do the ranks of
        ``mesh`` (the run's mesh) when each holds this local table as a
        replica."""
        return snapshot.save_table(self, path, mesh)

    @classmethod
    def restore(cls, path: str, spec: TableSpec, device=None,
                mesh=None) -> "Table":
        """Load an image (saved by either package) into a fresh table built
        for ``spec`` on ``device`` (default ``"cuda"``), or on ``mesh`` as
        :meth:`create` builds it. ``spec`` may differ
        from the spec the image was saved under — another ``dmax``, pool,
        lane width, slab capacity, backend, placement, shard count or
        mesh; the items re-route through
        the ordinary directory math, reactive splits included. Infeasible
        targets (a mismatched value schema among them) raise
        ``ValueError`` before any device work."""
        return snapshot.restore_table(path, spec, device, mesh)

    # -- one transaction ---------------------------------------------------

    def _apply_chunk(self, kinds, keys, values):
        """One ``n_lanes``-wide combining transaction, plus the payload
        side store's maintenance in schema mode. Returns (table', status,
        error): the error flag of any shard after it."""
        with telemetry.span("repro.facade.txn"):
            seq = self.seq + 1
            n = kinds.shape[0]
            seqs = torch.full((n,), seq, dtype=torch.int32,
                              device=self.device)
            if self.spec.value_schema is None:
                st, res = _raw_apply(self, self.state,
                                     OpBatch(kind=kinds, key=keys,
                                             value=values, seq=seqs))
                return (self._replace(state=st, seq=seq), res.status,
                        res.error)

            cap = self.spec.slab_rows
            # the transaction consumes the state: read the keys' handles
            # first
            with telemetry.span("repro.payload.lookup_before"):
                found0, h0 = _raw_lookup(self, self.state, keys)
            is_ins = kinds == INS
            isn = is_ins & ~found0
            first, rows, handle_new, exhausted = _alloc_handles(
                keys, isn, self.slab_live, cap)
            handle = torch.where(is_ins & found0, h0,
                                 torch.where(isn, handle_new, 0))
            st, res = _raw_apply(self, self.state,
                                 OpBatch(kind=kinds, key=keys, value=handle,
                                         seq=seqs))
            _write_payloads(self.slabs, values, keys, handle, is_ins,
                            res.status, cap)
            with telemetry.span("repro.payload.lookup_after"):
                found1, h1 = _raw_lookup(self, st, keys)
            _reconcile_handles(self.slab_live, found0, h0, first, rows,
                               found1, h1, cap)
            st = st._replace(error=st.error | exhausted)
            return (self._replace(state=st, seq=seq), res.status,
                    res.error | exhausted)

    # -- helpers -----------------------------------------------------------

    def _i32(self, x) -> torch.Tensor:
        """Host or device input → int32 tensor on the table's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        # np.array copies: a 1-element view may keep a negative stride
        return torch.tensor(np.array(x, np.int32), device=self.device)

    def _check_values(self, m: int, values):
        """Per-op values as tensors on the table's device: i32[m] in raw
        mode, ``{field: [m, *shape]}`` in the schema's dtypes otherwise
        (zeros when ``values`` is None: pure deletes and NOPs)."""
        schema = self.spec.value_schema
        if schema is None:
            if values is None:
                return torch.zeros(m, dtype=torch.int32, device=self.device)
            values = self._i32(values)
            if values.shape != (m,):
                raise ValueError(f"values have shape {tuple(values.shape)}, "
                                 f"want ({m},)")
            return values
        dtypes = self.spec.field_dtypes()
        if values is None:
            return {f.name: torch.zeros((m,) + f.shape, dtype=dtypes[f.name],
                                        device=self.device) for f in schema}
        if not isinstance(values, dict) or sorted(values) != sorted(dtypes):
            got = sorted(values) if isinstance(values, dict) else type(values)
            raise ValueError(f"schema fields {sorted(dtypes)}, got {got}")
        out = {}
        for f in schema:
            leaf = values[f.name]
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.as_tensor(np.array(leaf))
            leaf = leaf.to(device=self.device, dtype=dtypes[f.name])
            if leaf.shape != (m,) + f.shape:
                raise ValueError(f"field {f.name!r} has shape "
                                 f"{tuple(leaf.shape)}, want "
                                 f"{(m,) + f.shape}")
            out[f.name] = leaf
        return out


def create(spec: TableSpec, device=None, mesh=None) -> Table:
    """Module-level alias of :meth:`Table.create`."""
    return Table.create(spec, device, mesh)


def _mesh_device(spec: TableSpec, device, mesh) -> torch.device:
    """The device a table of ``spec`` goes on: ``device`` (default
    ``"cuda"``), or on ``mesh`` (validated against ``spec``) this rank's
    device of the mesh's type, which ``device`` may name but not
    contradict."""
    if mesh is None:
        return resolve_device(device)
    spec.check_mesh(mesh)
    kind = mesh.device_type
    dev = resolve_device(kind if device is None else device)
    if dev.type != kind:
        raise ValueError(f"a {kind} mesh cannot hold a table on {dev}")
    if kind == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# schema mode: handle allocation, payload scatter, liveness reconciliation


def _pad(x: torch.Tensor, length: int) -> torch.Tensor:
    """``x`` zero-padded along its first axis to ``length`` rows."""
    pad = length - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x


def _run_heads(keys, mask):
    """Over the ``mask`` lanes grouped by key: (order, is_start, is_end,
    in_mask). ``order`` is a stable sort of the lanes by key with the
    unmasked lanes last; the other three are in that order."""
    big = 1 << 40           # above every i32 key
    k = torch.where(mask, keys.to(torch.int64), big)
    order = torch.argsort(k, stable=True)
    ks = k[order]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    is_start = torch.cat([one, ks[1:] != ks[:-1]])
    is_end = torch.cat([ks[:-1] != ks[1:], one])
    return order, is_start, is_end, ks < big


def _alloc_handles(keys, isn, slab_live, cap: int):
    """Fresh handles for the new keys of a transaction: the first INS lane
    of each new key takes the next lowest free slab row (in lane order of
    those first lanes), and the key's later INS lanes share it. Returns
    (first bool[n], rows i32[n] (``cap`` off the first lanes), handle i32[n]
    (``cap`` off the new-key lanes), exhausted bool[]). One scan of the
    liveness bitmap: a cumulative count of free rows, searched for each
    first lane's rank."""
    with telemetry.span("repro.payload.alloc"):
        n = keys.shape[0]
        order, is_start, _, in_mask = _run_heads(keys, isn)
        first = torch.zeros(n, dtype=torch.bool, device=keys.device)
        first[order] = is_start & in_mask
        csum = torch.cumsum(~slab_live, 0)      # row `cap` is always live
        cum_first = torch.cumsum(first.to(torch.int64), 0)
        rows = torch.searchsorted(csum, cum_first).clamp(0, cap)
        rows = torch.where(first, rows, cap).to(torch.int32)
        exhausted = cum_first[-1] > csum[-1]
        # every lane of a key's run takes the row of the run's first lane
        head = T._cummax(torch.where(
            is_start, torch.arange(n, device=keys.device), -1))
        handle = torch.empty_like(rows)
        handle[order] = torch.where(in_mask, rows[order][head], cap)
        return first, rows, handle, exhausted


def _write_payloads(slabs, values, keys, handle, is_ins, status, cap: int):
    """Payload scatter after the transaction, gated on its statuses: only
    an INS that applied (TRUE/FALSE) writes — a FROZEN or OVERFLOW upsert
    leaves the key's payload untouched — and of one key's applied INS lanes
    only the last. Every other lane writes the trash row ``cap``."""
    with telemetry.span("repro.payload.write"):
        applied = is_ins & ((status == T.TRUE) | (status == T.FALSE))
        order, _, is_end, in_mask = _run_heads(keys, applied)
        write = torch.zeros_like(applied)
        write[order] = is_end & in_mask
        rows = torch.where(write, handle, cap).long()
        for name, slab in slabs.items():
            signed_view(slab)[rows] = signed_view(values[name])


def _reconcile_handles(slab_live, found0, h0, first, rows, found1, h1,
                       cap: int):
    """Liveness after the transaction, in place: free every handle the
    batch touched, then mark whatever the table maps each key to now — in
    this order, so that a freed-then-remapped handle ends live."""
    with telemetry.span("repro.payload.reconcile"):
        for mask, h, live in ((found0, h0, False), (first, rows, False),
                              (found1, h1, True)):
            telemetry.host_write("reconcile", slab_live,
                                 torch.where(mask, h, cap).long(), live)
        telemetry.host_write("reconcile", slab_live, cap, True)
