"""Measured dispatch cost model per (device, plan).

The port of the JAX package's ``repro/serving/router/costmodel.py``. The
facade dispatches an m-op batch as ``ceil(m / n_lanes)`` combining
transactions (``TableSpec.plan_batch``), so wall cost is a staircase

    cost(m) ~= base_s + n_chunks(m) * chunk_s

with ``base_s`` the fixed per-dispatch overhead (host launches, the
read-back of the results) and ``chunk_s`` the marginal cost of one more
n_lanes-wide transaction. Both depend on where the table runs — the CPU's
plain plan costs a different constant than the CUDA kernels — so the
model is **measured** on the live (device, plan) pair, not assumed:
:func:`measure_cost_model` times all-NOP transactions (content-transparent:
they run the full combining machinery and the resize policy's maintenance
passes, but change no content) on a scratch table built from the same
spec, and solves the two-point staircase for ``(base_s, chunk_s)``.

The router uses the model for adaptive batching: ``batch_floor`` is the
smallest batch that amortizes the fixed overhead down to a chosen slack
over the asymptotic per-op cost — under load the router batches at least
that much; with a shallow queue it dispatches early instead of idling
requests against latency it cannot buy back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """``cost(m) = base_s + ceil(m / n_lanes) * chunk_s`` (seconds)."""

    base_s: float
    chunk_s: float
    n_lanes: int
    source: str = "measured"     # "measured" | "default" | test stubs

    def __post_init__(self):
        if not (self.base_s >= 0.0 and self.chunk_s > 0.0
                and self.n_lanes > 0):
            raise ValueError(f"need base_s >= 0, chunk_s > 0 and n_lanes > 0"
                             f", got {self.base_s}, {self.chunk_s}, "
                             f"{self.n_lanes}")

    def dispatch_cost(self, m: int) -> float:
        """Predicted wall seconds for one m-op facade dispatch."""
        if m <= 0:
            return 0.0
        chunks = -(-m // self.n_lanes)
        return self.base_s + chunks * self.chunk_s

    def per_op_cost(self, m: int) -> float:
        return self.dispatch_cost(m) / m if m > 0 else float("inf")

    def throughput_ops_s(self, m: int) -> float:
        """Steady-state ops/s when every dispatch carries m ops."""
        c = self.dispatch_cost(m)
        return m / c if c > 0 else 0.0

    def batch_floor(self, slack: float = 1.0) -> int:
        """Smallest batch (a whole number of chunks) whose amortized fixed
        overhead is within ``slack`` of the asymptotic per-op cost:
        ``base_s / m <= slack * chunk_s / n_lanes``. The adaptive batcher
        waits for at least this much work under load."""
        if slack <= 0:
            raise ValueError(f"slack must be > 0, got {slack}")
        m = self.base_s * self.n_lanes / (slack * self.chunk_s)
        chunks = max(1, -(-int(np.ceil(m)) // self.n_lanes))
        return chunks * self.n_lanes


_CACHE: Dict[Tuple, CostModel] = {}


def _cache_key(table) -> Tuple:
    # keyed on the RESOLVED KernelPlan and the device type, not the
    # requested backend string: "auto" on the CPU and on the card are
    # different dispatches and must be measured apart
    spec, dev = table.spec, table.device.type
    return (dev, spec.placement, spec.n_lanes, spec.bucket_size,
            spec.pool_size, spec.dmax, spec.resize_policy is not None,
            spec.plan(dev))


def measure_cost_model(table, max_chunks: int = 8, repeats: int = 3,
                       clock=time.perf_counter) -> CostModel:
    """Fit ``(base_s, chunk_s)`` by timing real facade dispatches.

    Times all-NOP ``apply`` batches (1 chunk vs ``max_chunks`` chunks) on
    a **scratch table** built from the same spec on the same device, so
    the measurement leaves the live table's content and policy counters
    alone. Best-of-``repeats`` per point; each batch shape is run once
    untimed first (on the card that builds the kernels and warms the
    allocator). Each timed dispatch ends in a ``.cpu()`` read of its
    statuses, the router's own synchronization point. The scratch table
    is freed before this returns."""
    from repro_torch.table_api import Table

    spec = table.spec
    scratch = Table.create(spec, table.device)
    n = spec.n_lanes
    sizes = (n, n * max(2, max_chunks))

    def time_nop(m: int) -> float:
        nonlocal scratch
        # three explicit operands: the arg structure the router
        # dispatches with
        zeros = np.zeros(m, np.int32)
        scratch, res = scratch.apply(zeros, zeros, zeros)
        res.status.cpu()
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = clock()
            scratch, res = scratch.apply(zeros, zeros, zeros)
            res.status.cpu()
            best = min(best, clock() - t0)
        return best

    t_one = time_nop(sizes[0])
    t_many = time_nop(sizes[1])
    del scratch
    k_many = sizes[1] // n
    chunk_s = max((t_many - t_one) / (k_many - 1), 1e-9)
    base_s = max(t_one - chunk_s, 0.0)
    return CostModel(base_s=base_s, chunk_s=chunk_s, n_lanes=n)


def cost_model_for(table, use_cache: bool = True,
                   **measure_kw) -> CostModel:
    """Measured model for the table's (device, plan), cached per spec
    shape so routers over identical specs (tests, handover successors)
    measure once per process."""
    key = _cache_key(table)
    if use_cache and key in _CACHE:
        return _CACHE[key]
    model = measure_cost_model(table, **measure_kw)
    if use_cache:
        _CACHE[key] = model
    return model


def default_cost_model(n_lanes: int, base_s: float = 2e-4,
                       chunk_s: float = 1e-4) -> CostModel:
    """A deliberately unmeasured fallback (tests, dry runs)."""
    return CostModel(base_s=base_s, chunk_s=chunk_s, n_lanes=n_lanes,
                     source="default")


__all__ = [
    "CostModel",
    "measure_cost_model",
    "cost_model_for",
    "default_cost_model",
]
