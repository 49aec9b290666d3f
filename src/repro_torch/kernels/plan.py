"""Kernel execution plans: backend selection resolved once, up front.

A :class:`KernelPlan` is resolved once per ``TableSpec`` and device type,
when the first table on that device type is built, and never re-read on
the hot path:

  ``"plain"``  the plain transaction (``core/table.py::apply_batch``) and
               the plain probe (``core/table.py::lookup``);
  ``"cuda"``   the kernels (``kernels/ops.py``). Within the fused apply
               kernel's bound (one thread block of at most 1024 lanes,
               bucket rows of at most 32 slots in registers) a write
               transaction is one ``fused_apply`` launch and a lookup one
               ``fused_probe`` launch. Beyond it writes route in PyTorch and
               launch ``grouped_apply`` on the ops in lane order, and
               lookups route in PyTorch and launch ``probe``: a table whose
               writes leave the fused kernel routes its lookups the same
               way, as the JAX package does past its own fused bounds. Ops
               that meet a full bucket take the ``ST_FULL`` →
               ``apply_batch`` fallback. On CPU tensors each kernel wrapper
               runs its plain version, so this path also runs on the CPU.

``backend="auto"`` resolves to ``"cuda"`` on a CUDA device and to
``"plain"`` on the CPU. Every geometry has a plan.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.apply import fused_apply_supported

PLAN_BACKENDS = ("plain", "cuda")
SPEC_BACKENDS = ("auto",) + PLAN_BACKENDS
DEVICE_TYPES = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One table's resolved dispatch, as hashable static metadata.
    ``backend`` is post-resolution ("auto" never survives);
    ``fused_lookup`` / ``fused_apply`` select the fused kernels under
    ``"cuda"`` (the JAX plan's fields of the same names)."""

    backend: str
    fused_lookup: bool = True
    fused_apply: bool = True

    def __post_init__(self):
        assert self.backend in PLAN_BACKENDS, self.backend


def resolve_plan(spec, device_type: str) -> KernelPlan:
    """Resolve ``spec.backend`` for tables on ``device_type``. Reads only
    the spec's geometry and ``backend``."""
    if spec.backend not in SPEC_BACKENDS:
        raise ValueError(f"backend {spec.backend!r} not in {SPEC_BACKENDS}")
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device type {device_type!r} not in "
                         f"{DEVICE_TYPES}")
    backend = spec.backend
    if backend == "auto":
        backend = "cuda" if device_type == "cuda" else "plain"
    fused = (backend == "cuda"
             and fused_apply_supported(spec.n_lanes, spec.bucket_size))
    return KernelPlan(backend=backend, fused_lookup=fused, fused_apply=fused)


__all__ = ["KernelPlan", "resolve_plan", "PLAN_BACKENDS", "SPEC_BACKENDS"]
