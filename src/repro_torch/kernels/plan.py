"""Kernel execution plans: backend selection resolved once, up front.

A :class:`KernelPlan` is resolved once per ``TableSpec`` and device type,
when the first table on that device type is built, and never re-read on
the hot path:

  ``"plain"``  the plain transaction (``core/table.py::apply_batch``) and
               the plain probe (``core/table.py::lookup``);
  ``"cuda"``   the kernels: ``fused_probe`` for lookups, ``fused_apply``
               for writes with the ``ST_FULL`` → ``apply_batch`` fallback
               (``kernels/ops.py``). On CPU tensors each kernel wrapper runs
               its plain version, so this path also runs on the CPU.

``backend="auto"`` resolves to ``"cuda"`` on a CUDA device and to
``"plain"`` on the CPU. The fused-apply bound is the kernel's own (one
thread block of at most 1024 lanes, bucket rows of at most 32 slots in
registers); a geometry outside it has no kernel yet (the grouped apply
kernel is not ported), so a ``"cuda"`` plan for a CUDA table of that
geometry raises — it never falls back to the plain transaction. On the CPU
the wrappers' plain versions have no such bound.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.apply import (MAX_BUCKET_SIZE, MAX_LANES,
                                       fused_apply_supported)

PLAN_BACKENDS = ("plain", "cuda")
SPEC_BACKENDS = ("auto",) + PLAN_BACKENDS
DEVICE_TYPES = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One table's resolved dispatch, as hashable static metadata.
    ``backend`` is post-resolution ("auto" never survives)."""

    backend: str

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
    if (backend == "cuda" and device_type == "cuda"
            and not fused_apply_supported(spec.n_lanes, spec.bucket_size)):
        raise NotImplementedError(
            f"n_lanes={spec.n_lanes}, bucket_size={spec.bucket_size} is "
            f"outside the fused-apply kernel (n_lanes <= {MAX_LANES}, "
            f"bucket_size <= {MAX_BUCKET_SIZE}); the grouped apply kernel "
            "that would serve it is not ported yet")
    return KernelPlan(backend=backend)


__all__ = ["KernelPlan", "resolve_plan", "PLAN_BACKENDS", "SPEC_BACKENDS"]
