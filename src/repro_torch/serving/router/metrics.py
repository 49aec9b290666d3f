"""Per-request latency accounting for the serving tier.

The JAX package's ``repro/serving/router/metrics.py`` (numpy only),
unchanged in behaviour. Every request carries three timestamps — submit
(enqueue), dispatch, and complete — and the router folds the three
derived latencies into log-bucketed :class:`LatencyHistogram` instances:

* **queue wait** (``dispatch - submit``) — time spent in the admission
  queue; the adaptive batcher trades this against amortization;
* **service** (``complete - dispatch``) — the facade transaction itself
  (measured wall time of the combining transaction(s) and the read-back
  of their results);
* **total** (``complete - submit``) — what a client observes, and what
  the p50/p99/p999 SLO targets gate on.

Histograms are geometric (fixed buckets per decade), so percentile error
is bounded by the bucket ratio (~12% at 20 buckets/decade) regardless of
how many requests are folded in — O(1) memory per series at any load, the
only shape that survives "millions of users". :class:`RouterMetrics`
aggregates the three series with the admission/backpressure counters into
one JSON-able report.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

_DEFAULT_LO = 1e-6          # 1 us
_DEFAULT_HI = 1e3           # 1000 s (beyond = clamped into the last bucket)
_PER_DECADE = 20


class LatencyHistogram:
    """Log-bucketed latency histogram with interpolated percentiles.

    Buckets are geometric between ``lo`` and ``hi`` seconds
    (``per_decade`` buckets per decade); samples below ``lo`` land in the
    first bucket, above ``hi`` in the last. ``percentile`` interpolates
    linearly inside the winning bucket, so its error is bounded by one
    bucket ratio — plenty for p50/p99/p999 SLO reporting.
    """

    def __init__(self, lo: float = _DEFAULT_LO, hi: float = _DEFAULT_HI,
                 per_decade: int = _PER_DECADE):
        if not (0 < lo < hi and per_decade > 0):
            raise ValueError(f"need 0 < lo < hi and per_decade > 0, got "
                             f"{lo}, {hi}, {per_decade}")
        n = int(math.ceil(math.log10(hi / lo) * per_decade))
        # edges[i] .. edges[i+1] bound bucket i (n buckets, n+1 edges)
        self.edges = lo * np.power(10.0, np.arange(n + 1) / per_decade)
        self.counts = np.zeros(n, np.int64)
        self.total = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def add(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        i = int(np.searchsorted(self.edges, s, side="right")) - 1
        self.counts[min(max(i, 0), len(self.counts) - 1)] += 1
        self.total += 1
        self.sum_s += s
        self.min_s = min(self.min_s, s)
        self.max_s = max(self.max_s, s)

    def add_many(self, seconds) -> None:
        for s in np.asarray(seconds, np.float64).reshape(-1):
            self.add(float(s))

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile in seconds (p in [0, 100])."""
        if self.total == 0:
            return 0.0
        rank = (p / 100.0) * self.total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        i = min(i, len(self.counts) - 1)
        in_bucket = self.counts[i]
        before = cum[i] - in_bucket
        frac = ((rank - before) / in_bucket) if in_bucket else 0.0
        lo, hi = self.edges[i], self.edges[i + 1]
        est = lo + frac * (hi - lo)
        # never report outside the observed range (tails of sparse data)
        return float(min(max(est, self.min_s), self.max_s))

    def summary(self) -> Dict[str, float]:
        if self.total == 0:
            return {"count": 0}
        return {
            "count": int(self.total),
            "mean_ms": round(self.sum_s / self.total * 1e3, 6),
            "p50_ms": round(self.percentile(50) * 1e3, 6),
            "p99_ms": round(self.percentile(99) * 1e3, 6),
            "p999_ms": round(self.percentile(99.9) * 1e3, 6),
            "min_ms": round(self.min_s * 1e3, 6),
            "max_ms": round(self.max_s * 1e3, 6),
        }


@dataclasses.dataclass
class RouterMetrics:
    """The router's observability surface: three latency series plus the
    admission-control and rolling-upgrade counters (``dropped`` must stay
    0 across handovers — the zero-dropped-requests acceptance check)."""

    queue_wait: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    service: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    total: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    shed_queue_full: int = 0
    shed_pressure: int = 0
    dispatches: int = 0          # pump rounds that dispatched work
    dispatched_ops: int = 0      # mutation ops dispatched
    lookup_ops: int = 0          # read ops dispatched
    deferred_rounds: int = 0     # rounds that withheld writes (pressure)
    maintenance_rounds: int = 0  # all-NOP rounds run to drain pressure
    handovers: int = 0
    dropped: int = 0             # MUST stay 0 (rolling upgrade invariant)
    peak_pressure: float = 0.0
    busy_s: float = 0.0          # service seconds summed over dispatches

    def record_complete(self, t_submit: float, t_dispatch: float,
                        t_complete: float) -> None:
        self.completed += 1
        self.queue_wait.add(t_dispatch - t_submit)
        self.service.add(t_complete - t_dispatch)
        self.total.add(t_complete - t_submit)

    def mean_batch(self) -> float:
        if self.dispatches == 0:
            return 0.0
        return (self.dispatched_ops + self.lookup_ops) / self.dispatches

    def snapshot(self, slo_p50_ms: Optional[float] = None,
                 slo_p99_ms: Optional[float] = None) -> dict:
        """JSON-able report; when SLO targets are given, attaches a
        pass/fail verdict on the total-latency series."""
        out = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "shed_queue_full": self.shed_queue_full,
            "shed_pressure": self.shed_pressure,
            "dispatches": self.dispatches,
            "dispatched_ops": self.dispatched_ops,
            "lookup_ops": self.lookup_ops,
            "deferred_rounds": self.deferred_rounds,
            "maintenance_rounds": self.maintenance_rounds,
            "mean_batch": round(self.mean_batch(), 3),
            "handovers": self.handovers,
            "dropped": self.dropped,
            "peak_pressure": round(self.peak_pressure, 4),
            "busy_s": self.busy_s,
            "queue_wait": self.queue_wait.summary(),
            "service": self.service.summary(),
            "total": self.total.summary(),
        }
        if slo_p50_ms is not None or slo_p99_ms is not None:
            tot = out["total"]
            checks = {}
            if slo_p50_ms is not None and tot.get("count"):
                checks["p50"] = {"target_ms": slo_p50_ms,
                                 "actual_ms": tot["p50_ms"],
                                 "ok": tot["p50_ms"] <= slo_p50_ms}
            if slo_p99_ms is not None and tot.get("count"):
                checks["p99"] = {"target_ms": slo_p99_ms,
                                 "actual_ms": tot["p99_ms"],
                                 "ok": tot["p99_ms"] <= slo_p99_ms}
            out["slo"] = checks
        return out
