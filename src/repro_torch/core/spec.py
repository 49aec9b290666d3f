"""Declarative table specification: one object describing a table.

``TableSpec`` has the field names of the JAX package's spec
(``repro/core/spec.py``). This port serves local placement and sharded
placement (``core/dist.py``: the top ``shard_bits`` of the hash pick one
of ``2**shard_bits`` shards, stacked on the table's one device or spread
over the ``model`` axis of a ``(data, model)`` device mesh) with
raw i32 values or a **value schema**, the paper-reactive resize rule or an
elastic :class:`~repro_torch.core.policy.ResizePolicy`, and saves and
restores tables through the JAX package's image format
(``core/snapshot.py``). ``backend`` is ``"auto"``, ``"plain"`` or
``"cuda"`` and ``autotune`` is ``"off"`` or ``"measured"`` (the kernels'
launch shapes timed on the device, see ``kernels/plan.py`` and
``kernels/tuning.py``); the spec resolves its kernel plan once per device
type, when the first table on it is built, and every geometry has one.

Value schemas
-------------
A schema is declared as a mapping ``name -> dtype`` or ``name -> (dtype,
per-item shape)``::

    schema = {"page": "int32", "score": (torch.float32, (4,))}

and is normalized to a sorted tuple of :class:`ValueField` whose dtypes are
numpy dtype names (``"int32"``, ``"float32"``, ``"bfloat16"``, ...), the
names the JAX package writes, so that image headers match. A 64-bit field
keeps its full width here; the JAX package, with x64 off, keeps it in a
32-bit slab. With a schema the table stores payloads in a struct-of-slabs
side store: one tensor of shape ``[slab_rows + 1, *field_shape]`` per
field, indexed by a stable handle that travels in the table's i32 value
word. Row ``slab_rows`` is the write-trash row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import table as T
from repro_torch.core.policy import ResizePolicy

PLACEMENTS = ("local", "sharded")


class ValueField(NamedTuple):
    """One leaf of a value schema (hashable normal form)."""

    name: str
    dtype: str            # numpy dtype name, e.g. "int32"
    shape: Tuple[int, ...] = ()   # per-item shape (() = scalar payload)


def _dtype_name(dtype) -> str:
    """The numpy name of ``dtype`` (a string, a numpy dtype or a
    ``torch.dtype``); ``bfloat16``, which numpy lacks, maps by name. A
    torch dtype without a numpy counterpart raises."""
    if dtype is torch.bfloat16 or str(dtype) == "bfloat16":
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype.name
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a schema field's numpy dtype name."""
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, name)).dtype


# same-width signed counterparts: PyTorch lacks index_put for unsigned
# tensors, so payloads are scattered and gathered through these views
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def signed_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as its same-width signed type when it is unsigned
    (16 bits and wider), else ``x`` itself: the same bytes either way."""
    signed = _SIGNED.get(x.dtype)
    return x if signed is None else x.view(signed)


def normalize_schema(schema: Any) -> Optional[Tuple[ValueField, ...]]:
    """Normalize a user schema to a sorted, hashable ``ValueField`` tuple.

    Accepts ``None`` (raw i32 value mode), a mapping ``name -> spec``, or a
    sequence of ``ValueField``/tuples. A field spec may be a dtype, a
    ``(dtype, shape)`` pair, or anything with ``.dtype``/``.shape``."""
    if schema is None:
        return None
    if isinstance(schema, Mapping):
        items = schema.items()
    else:
        items = [(f[0], (f[1], tuple(f[2]) if len(f) > 2 else ()))
                 for f in schema]
    fields = []
    for name, spec in items:
        if isinstance(spec, tuple):
            dtype, shape = spec[0], tuple(spec[1])
        elif isinstance(spec, (str, type, np.dtype, torch.dtype)):
            dtype, shape = spec, ()
        else:       # an array-like description: .dtype and .shape
            dtype, shape = spec.dtype, tuple(spec.shape)
        fields.append(ValueField(str(name), _dtype_name(dtype),
                                 tuple(int(s) for s in shape)))
    if not fields:
        return None
    out = tuple(sorted(fields))
    names = [f.name for f in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate schema fields: {names}")
    return out


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Everything about a table, in one declarative, hashable object.
    Build the handle with ``repro_torch.table_api.Table.create``."""

    # --- core table sizing (TableConfig mirror) --------------------------
    dmax: int = 8
    bucket_size: int = 8
    pool_size: int = 256
    n_lanes: int = 16            # lanes per combining transaction
    hash_name: str = "fmix32"
    initial_depth: int = 0
    max_rounds: int = 0
    use_fast_path: bool = True

    # --- placement -------------------------------------------------------
    # (data_axis / model_axis name the axes of a sharded table's mesh:
    # see check_mesh)
    placement: str = "local"     # "local" | "sharded"
    shard_bits: int = 1          # sharded: 2**shard_bits table shards
    data_axis: str = "data"
    model_axis: str = "model"

    # --- backend ---------------------------------------------------------
    backend: str = "auto"        # "auto" | "plain" | "cuda"
    autotune: str = "off"        # "off" | "measured" (kernels/tuning.py)

    # --- value schema ----------------------------------------------------
    value_schema: Optional[Tuple[ValueField, ...]] = None
    slab_capacity: int = 0       # 0 → pool_size * bucket_size (max items)

    # --- elastic resize policy (core/policy.py; None = paper-reactive) ----
    resize_policy: Optional[ResizePolicy] = None

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")
        if self.placement == "sharded" and not 1 <= self.shard_bits <= 8:
            raise ValueError(f"shard_bits {self.shard_bits} outside [1, 8]")
        if self.resize_policy is not None:
            if not isinstance(self.resize_policy, ResizePolicy):
                raise TypeError(f"resize_policy must be a ResizePolicy, "
                                f"not {type(self.resize_policy).__name__}")
            # the bucket-size-dependent checks: the policy alone cannot
            # see bucket_size
            self.resize_policy.validate(self.bucket_size, self.dmax)
        object.__setattr__(self, "value_schema",
                           normalize_schema(self.value_schema))
        if self.slab_capacity and self.value_schema is None:
            raise ValueError("slab_capacity given without a value_schema")
        # construction-time validation of the core knobs and the backend;
        # plans resolve when first asked for, so that a measured plan times
        # its sweep only on the device type it is resolved for
        self.table_config()
        from repro_torch.kernels.plan import AUTOTUNE_POLICIES, SPEC_BACKENDS
        if self.backend not in SPEC_BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in "
                             f"{SPEC_BACKENDS}")
        if self.autotune not in AUTOTUNE_POLICIES:
            raise ValueError(f"autotune {self.autotune!r} not in "
                             f"{AUTOTUNE_POLICIES}")
        object.__setattr__(self, "_plans", {})

    def plan(self, device_type: str):
        """The :class:`~repro_torch.kernels.plan.KernelPlan` for tables on
        ``device_type``: resolved once, when the first table on that device
        type is built (``Table.create`` / ``from_state``)."""
        if device_type not in self._plans:
            from repro_torch.kernels.plan import resolve_plan
            self._plans[device_type] = resolve_plan(self, device_type)
        return self._plans[device_type]

    @property
    def slab_rows(self) -> int:
        """Payload rows of the side store (0 in raw value mode)."""
        if self.value_schema is None:
            return 0
        return self.slab_capacity or self.pool_size * self.bucket_size

    @property
    def n_shards(self) -> int:
        """Table shards: ``2**shard_bits`` for sharded placement, else 1."""
        return 1 << self.shard_bits if self.placement == "sharded" else 1

    def field_dtypes(self) -> dict:
        """``{field name: torch.dtype}`` of the value schema."""
        if self.value_schema is None:
            raise ValueError("the spec has no value_schema")
        return {f.name: torch_dtype(f.dtype) for f in self.value_schema}

    def plan_batch(self, m: int) -> Tuple[int, int]:
        """``(n_chunks, padded_len)`` the facade dispatches for an
        ``m``-op batch: NOP-padded to whole ``n_lanes``-wide transactions
        (0 chunks for an empty batch)."""
        if m <= 0:
            return 0, 0
        chunks = -(-m // self.n_lanes)
        return chunks, chunks * self.n_lanes

    def table_config(self) -> T.TableConfig:
        """The local-table config this spec resolves to. For sharded
        placement this is the PER-SHARD config: the shard id consumes the
        top ``shard_bits`` hash bits, and every shard sees the whole
        ``n_lanes``-wide announced batch."""
        shift = self.shard_bits if self.placement == "sharded" else 0
        return T.TableConfig(
            dmax=self.dmax, bucket_size=self.bucket_size,
            pool_size=self.pool_size, n_lanes=self.n_lanes,
            hash_name=self.hash_name, hash_shift=shift,
            initial_depth=self.initial_depth, max_rounds=self.max_rounds,
            use_fast_path=self.use_fast_path)

    def dist_config(self):
        """The :class:`~repro_torch.core.dist.DistConfig` of a sharded
        spec: ``table_config()`` is its per-shard config (imported here:
        ``core/dist.py`` imports the table module)."""
        from repro_torch.core import dist as D
        if self.placement != "sharded":
            raise ValueError("dist_config needs placement='sharded'")
        return D.DistConfig(shard_bits=self.shard_bits,
                            data_axis=self.data_axis,
                            model_axis=self.model_axis,
                            local=self.table_config())

    def check_mesh(self, mesh) -> None:
        """Raise ``ValueError`` unless a table of this spec can be laid out
        on ``mesh`` (a ``torch.distributed`` ``DeviceMesh``), as the JAX
        ``Table.create`` asserts: a sharded spec, a mesh with both the
        ``data_axis`` and the ``model_axis``, ``model`` dividing
        ``n_shards`` (a rank holds ``n_shards / model`` shards; the JAX
        package needs exactly one), ``data`` dividing ``n_lanes``, and the
        mesh spanning the whole process group."""
        import torch.distributed as dist
        if self.placement != "sharded":
            raise ValueError("a mesh needs placement='sharded'; a local "
                             "table lives on one device")
        names = tuple(mesh.mesh_dim_names or ())
        for axis in (self.data_axis, self.model_axis):
            if axis not in names:
                raise ValueError(f"the mesh has axes {names}, not "
                                 f"{axis!r}")
        data = mesh.size(names.index(self.data_axis))
        model = mesh.size(names.index(self.model_axis))
        if self.n_shards % model:
            raise ValueError(f"mesh axis {self.model_axis!r}={model} does "
                             f"not divide n_shards={self.n_shards}")
        if self.n_lanes % data:
            raise ValueError(f"mesh axis {self.data_axis!r}={data} does "
                             f"not divide n_lanes={self.n_lanes}")
        world = dist.get_world_size() if dist.is_initialized() else 0
        if mesh.size() != world:
            raise ValueError(f"the mesh has {mesh.size()} ranks; the "
                             f"process group has {world}")
