"""Declarative table specification: one object describing a table.

``TableSpec`` has the field names of the JAX package's spec
(``repro/core/spec.py``). This port serves local placement with raw i32
values and the paper-reactive resize rule, and saves and restores tables
through the JAX package's image format (``core/snapshot.py``);
``placement="sharded"``, a ``value_schema``, a ``resize_policy`` and
measured tile autotuning raise ``NotImplementedError`` until they are
ported. ``backend`` is ``"auto"``, ``"plain"`` or ``"cuda"`` (see
``kernels/plan.py``); the spec resolves its kernel plan once per device
type, when the first table on it is built, and every geometry has one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.core import table as T

PLACEMENTS = ("local", "sharded")


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
    placement: str = "local"     # "local" ("sharded" is not ported yet)
    shard_bits: int = 1
    data_axis: str = "data"
    model_axis: str = "model"

    # --- backend ---------------------------------------------------------
    backend: str = "auto"        # "auto" | "plain" | "cuda"
    autotune: str = "off"        # "off" (the tile autotuner is not ported)

    # --- value schema and elastic policy (not ported yet) ---------------
    value_schema: Optional[Tuple[Any, ...]] = None
    slab_capacity: int = 0
    resize_policy: Optional[Any] = None

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENTS}")
        for name, supported in (("placement", self.placement == "local"),
                                ("value_schema", self.value_schema is None),
                                ("slab_capacity", self.slab_capacity == 0),
                                ("resize_policy", self.resize_policy is None),
                                ("autotune", self.autotune == "off")):
            if not supported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported to the "
                    "PyTorch package yet (local placement, raw i32 values, "
                    "no resize policy or autotuning)")
        # construction-time validation of the core knobs and the backend
        self.table_config()
        from repro_torch.kernels.plan import resolve_plan
        object.__setattr__(self, "_plans", {"cpu": resolve_plan(self, "cpu")})

    def plan(self, device_type: str):
        """The :class:`~repro_torch.kernels.plan.KernelPlan` for tables on
        ``device_type``: resolved once, when the first table on that device
        type is built (``Table.create`` / ``from_state``)."""
        if device_type not in self._plans:
            from repro_torch.kernels.plan import resolve_plan
            self._plans[device_type] = resolve_plan(self, device_type)
        return self._plans[device_type]

    def plan_batch(self, m: int) -> Tuple[int, int]:
        """``(n_chunks, padded_len)`` the facade dispatches for an
        ``m``-op batch: NOP-padded to whole ``n_lanes``-wide transactions
        (0 chunks for an empty batch)."""
        if m <= 0:
            return 0, 0
        chunks = -(-m // self.n_lanes)
        return chunks, chunks * self.n_lanes

    def table_config(self) -> T.TableConfig:
        """The local-table config this spec resolves to."""
        return T.TableConfig(
            dmax=self.dmax, bucket_size=self.bucket_size,
            pool_size=self.pool_size, n_lanes=self.n_lanes,
            hash_name=self.hash_name, hash_shift=0,
            initial_depth=self.initial_depth, max_rounds=self.max_rounds,
            use_fast_path=self.use_fast_path)
