"""The request router: adaptive batching + admission control + upgrades.

The port of the JAX package's ``repro/serving/router/router.py``. Many
concurrent client streams submit *individual* lookup/upsert/delete
requests; the router turns them back into the batched combining
transactions the table is fast at, without giving up per-request latency
accounting. One ``Router`` instance owns one
:class:`repro_torch.table_api.Table` (either placement, any backend, any
device) and runs three control loops:

**Adaptive batching** — admitted requests accumulate in arrival-ordered
queues; a pump dispatches when there is enough work to amortize the fixed
dispatch overhead (``CostModel.batch_floor``, measured per (device,
plan)), when the queue hits ``max_batch``, or when the oldest request has
waited ``max_delay_s`` — so a shallow queue dispatches early (latency)
while a deep queue rides the batch-size staircase (throughput). Batches
are variable-length: the facade NOP-pads and chunks whatever the router
hands it (``TableSpec.plan_batch`` is the shared cost contract).

**Admission control & backpressure** — queue depth is bounded per shard
(``ShardQueues``); requests to a backed-up shard are shed at submit. The
elastic :class:`~repro_torch.core.policy.ResizePolicy` reports imminent
split/merge work through ``Table.policy_stats()["pressure"]``; the router
EWMA-filters it and (a) *defers* queued writes while reads keep flowing
when pressure crosses ``pressure_defer`` (bounded by ``max_delay_s`` —
deferral never becomes starvation), and (b) *sheds* new writes above
``pressure_shed``.

**Rolling upgrade** — :meth:`Router.handover` re-seats the live table
under a successor spec through its canonical in-memory image
(``extract_image``/``restore_from_image``). Queued and deferred requests
are retained verbatim and complete on the successor: zero dropped
requests, counted and checked (``metrics.dropped``). The queues re-home
every queued request under the successor's shards, so a handover may
change the placement or the shard count (the JAX router keeps the
predecessor's shard counters, which a local -> sharded handover overruns).

Every dispatch ends in a ``.cpu()`` read of its statuses and lookup
results: that read is the synchronization point, so the measured service
time covers the device work. The router is single-threaded and
clock-injected: "time" is whatever the caller passes (wall clock by
default, a virtual clock in the closed-loop driver), which keeps every
latency experiment deterministic and the differential oracle replayable.

**On a mesh of ranks** (the table's ``DeviceMesh``, kept as the run's
mesh when a handover lands on a local replica) every rank runs the
same router on the same global request stream, and every branch is a
function of what is equal on every rank: the queues and the config (by
construction), ``pressure`` (``policy_stats`` is reduced over ``model``),
the cost model (rank 0's fit, broadcast) and the times the router reads.
Each time read from the host — a dispatch's service time after its
``.cpu()`` reads, and ``clock()`` when the caller passes no ``now`` — is
global rank 0's, broadcast (``core/dist.py::agree``; counted in
``agreements``). So every rank batches, sheds and defers the same
requests, the facade's collectives see the same shapes, and ``report()``
is the same everywhere.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.dist import agree
from repro_torch.serving.router import queue as Q
from repro_torch.serving.router.costmodel import CostModel, cost_model_for
from repro_torch.serving.router.metrics import RouterMetrics
from repro_torch.serving.router.queue import Request, ShardQueues


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs. Invalid values raise ``ValueError``."""

    max_batch: int = 64              # ops per dispatch per channel (cap)
    max_queue_per_shard: int = 128   # admission bound (per home shard)
    max_delay_s: float = 2e-3        # oldest-request wait that forces dispatch
    amortize_slack: float = 1.0      # batch_floor slack over asymptotic cost
    pressure_defer: float = 0.35     # EWMA pressure that defers writes
    pressure_shed: float = 0.75      # EWMA pressure that sheds new writes
    pressure_alpha: float = 0.3      # EWMA weight of the newest sample
    slo_p50_ms: Optional[float] = None   # reporting targets (report())
    slo_p99_ms: Optional[float] = None

    def __post_init__(self):
        for ok, what in (
                (self.max_batch >= 1 and self.max_queue_per_shard >= 1,
                 "max_batch and max_queue_per_shard must be >= 1"),
                (self.max_delay_s > 0 and self.amortize_slack > 0,
                 "max_delay_s and amortize_slack must be > 0"),
                (0.0 < self.pressure_defer <= self.pressure_shed <= 1.0,
                 "need 0 < pressure_defer <= pressure_shed <= 1"),
                (0.0 < self.pressure_alpha <= 1.0,
                 "need 0 < pressure_alpha <= 1")):
            if not ok:
                raise ValueError(f"RouterConfig: {what} ({self})")


class Router:
    """One serving router over one table handle (see module docstring).

    The router owns the only live reference to its table: the port's
    writes consume the handle they are called on, and ``router.table`` is
    always the latest post-transaction handle (it swaps wholesale on
    :meth:`handover`). ``mesh`` is the run's mesh, over which the host
    timings are agreed: the table's, and after a handover onto a local
    replica in a mesh run, still the run's."""

    def __init__(self, table, config: RouterConfig = RouterConfig(),
                 cost_model: Optional[CostModel] = None,
                 clock=time.perf_counter, on_event=None):
        spec = table.spec
        if spec.value_schema is not None:
            raise ValueError(
                "the serving router routes the raw i32 value mode only")
        self.table = table
        self.config = config
        self.clock = clock
        self.mesh = table.mesh
        # host readings broadcast from rank 0 (one per dispatch, one per
        # clock() reading); 0 off a mesh
        self.agreements = 0
        self.cost_model = cost_model or cost_model_for(table)
        self.queues = ShardQueues(spec.n_shards, config.max_queue_per_shard)
        self.metrics = RouterMetrics()
        self.pressure = 0.0
        self._next_rid = 0
        # observability hook: on_event(name, info_dict) fires on the
        # control-plane transitions external harnesses care about
        # (handover begin/end, maintenance rounds); None = no-op. The
        # chaos harness records these to check that its injected
        # handovers really went through the router
        self.on_event = on_event

    def _emit(self, name: str, **info) -> None:
        if self.on_event is not None:
            self.on_event(name, info)

    def _agreed(self, seconds: float) -> float:
        """A host reading, global rank 0's on a mesh (one broadcast)."""
        if self.mesh is None:
            return seconds
        self.agreements += 1
        return agree([seconds], self.mesh)[0]

    def _now(self, now: Optional[float]) -> float:
        return self._agreed(self.clock()) if now is None else now

    # -- derived control values -------------------------------------------

    @property
    def batch_floor(self) -> int:
        """Amortization target from the measured cost model, capped by
        ``max_batch`` (recomputed each call: handover may swap models)."""
        return min(self.config.max_batch,
                   self.cost_model.batch_floor(self.config.amortize_slack))

    def warmup(self) -> None:
        """Run every dispatch shape this router can emit once.

        The facade pads any m-op batch to a whole number of n_lanes-wide
        chunks, so there is one shape per chunk count up to ``max_batch``
        (for apply and for lookup). Running each once on a scratch table
        of the same spec and device (and mesh: the communicators are
        built here too) builds the kernels and warms the allocator outside
        the serving path's latency tails; the scratch table is freed
        before this returns."""
        from repro_torch.table_api import Table

        scratch = Table.create(self.table.spec, self.table.device,
                               self.table.mesh)
        n = self.table.spec.n_lanes
        top = -(-self.config.max_batch // n) * n
        for m in range(n, top + 1, n):
            zeros = np.zeros(m, np.int32)
            scratch, res = scratch.apply(zeros, zeros, zeros)
            res.status.cpu()
            found, _ = scratch.lookup(zeros)
            found.cpu()
        del scratch

    # -- admission ---------------------------------------------------------

    def submit(self, kind: int, key: int, value: int = 0,
               now: Optional[float] = None) -> Tuple[Optional[Request], str]:
        """Admit one request. Returns ``(request, decision)`` — request is
        None when shed (``decision`` says why); an admitted request's
        result lands on the same object when its batch completes."""
        if kind not in (Q.READ, Q.INS, Q.DEL):
            raise ValueError(f"request kind {kind!r} not in READ/INS/DEL")
        now = self._now(now)
        self.metrics.submitted += 1
        if kind != Q.READ and self.pressure >= self.config.pressure_shed:
            self.metrics.shed_pressure += 1
            return None, Q.SHED_PRESSURE
        req = Request(rid=self._next_rid, kind=kind, key=int(key),
                      value=int(value), shard=Q.shard_of(key, self.table.spec),
                      t_submit=now)
        if not self.queues.admit(req):
            self.metrics.shed_queue_full += 1
            return None, Q.SHED_QUEUE_FULL
        self._next_rid += 1
        self.metrics.admitted += 1
        return req, Q.ADMITTED

    # -- dispatch ----------------------------------------------------------

    def should_dispatch(self, now: float) -> bool:
        """The adaptive-batching decision: enough work to amortize, a full
        batch, or an aging head-of-line request."""
        depth = len(self.queues)
        if depth == 0:
            return False
        return (depth >= self.batch_floor
                or depth >= self.config.max_batch
                or self.queues.oldest_wait(now) >= self.config.max_delay_s)

    def pump(self, now: Optional[float] = None,
             force: bool = False) -> List[Request]:
        """Dispatch if the batcher says so; returns completed requests in
        linearization order (mutations in lane order, then reads)."""
        now = self._now(now)
        if not force and not self.should_dispatch(now):
            # idle under pressure: drain the policy backlog so shedding
            # is transient (all-NOP rounds run split/merge maintenance)
            if (len(self.queues) == 0
                    and self.table.spec.resize_policy is not None
                    and self.pressure >= self.config.pressure_defer):
                self._maintenance_round()
            return []
        if len(self.queues) == 0:
            return []
        return self._dispatch(now)

    def flush(self, now: Optional[float] = None) -> List[Request]:
        """Drain everything (deferred writes included): repeated forced
        dispatches until the queues are empty. Used by drains, upgrades
        and end-of-trace."""
        now = self._now(now)
        out: List[Request] = []
        while len(self.queues):
            done = self._dispatch(now, ignore_pressure=True)
            if done:
                now = max(now, done[-1].t_complete)
            out.extend(done)
        return out

    def _dispatch(self, now: float,
                  ignore_pressure: bool = False) -> List[Request]:
        cfg = self.config
        defer_writes = (not ignore_pressure
                        and self.pressure >= cfg.pressure_defer
                        and self.queues.n_reads > 0
                        # deferral is bounded: an aging write goes anyway
                        and self.queues.oldest_write_wait(now)
                        < cfg.max_delay_s)
        if defer_writes and self.queues.n_writes:
            self.metrics.deferred_rounds += 1
        writes = ([] if defer_writes
                  else self.queues.take_writes(cfg.max_batch))
        reads = self.queues.take_reads(cfg.max_batch)
        if not writes and not reads:
            return []

        # batches are quantized host-side to whole n_lanes chunks (NOP /
        # zero-key padding), the shapes warmup() ran
        wall0 = time.perf_counter()
        if writes:
            m = len(writes)
            _, padded = self.table.spec.plan_batch(m)
            kinds = np.zeros(padded, np.int32)
            keys = np.zeros(padded, np.int32)
            vals = np.zeros(padded, np.int32)
            kinds[:m] = [r.kind for r in writes]
            keys[:m] = [r.key for r in writes]
            vals[:m] = [r.value for r in writes]
            self.table, res = self.table.apply(kinds, keys, vals)
            status = res.status.cpu().numpy()
        if reads:
            m = len(reads)
            _, padded = self.table.spec.plan_batch(m)
            qkeys = np.zeros(padded, np.int32)
            qkeys[:m] = [r.key for r in reads]
            found, vals_out = self.table.lookup(qkeys)
            found = found.cpu().numpy()
            vals_out = vals_out.cpu().numpy()
        service_s = self._agreed(time.perf_counter() - wall0)
        t_done = now + service_s

        for lane, r in enumerate(writes):
            r.t_dispatch, r.t_complete = now, t_done
            r.status = int(status[lane])
            self.metrics.record_complete(r.t_submit, now, t_done)
        for i, r in enumerate(reads):
            r.t_dispatch, r.t_complete = now, t_done
            r.found = bool(found[i])
            r.result = int(vals_out[i]) if r.found else None
            self.metrics.record_complete(r.t_submit, now, t_done)

        self.metrics.dispatches += 1
        self.metrics.busy_s += service_s
        self.metrics.dispatched_ops += len(writes)
        self.metrics.lookup_ops += len(reads)
        if self.table.spec.resize_policy is not None:
            if writes:
                self._resample_pressure()
            elif self.pressure >= cfg.pressure_defer:
                # a round that withheld/shed all writes must still make
                # resize progress, or high pressure becomes permanent:
                # an all-NOP transaction runs the policy's maintenance
                # passes without touching content
                self._maintenance_round()
        return writes + reads

    def _resample_pressure(self) -> None:
        """EWMA-fold the policy's backpressure signal off the live state."""
        sample = float(self.table.policy_stats()["pressure"])
        a = self.config.pressure_alpha
        self.pressure = (1 - a) * self.pressure + a * sample
        self.metrics.peak_pressure = max(self.metrics.peak_pressure,
                                         self.pressure)

    def _maintenance_round(self) -> None:
        """One content-transparent all-NOP transaction: the elastic policy
        does a split/merge maintenance pass, then pressure is resampled —
        the escape hatch that keeps write shedding transient."""
        n = self.table.spec.n_lanes
        zeros = np.zeros(n, np.int32)
        self.table, res = self.table.apply(zeros, zeros, zeros)
        res.status.cpu()
        self.metrics.maintenance_rounds += 1
        self._resample_pressure()
        self._emit("maintenance", pressure=round(self.pressure, 4))

    # -- rolling upgrade ---------------------------------------------------

    def handover(self, new_spec, device=None, mesh=None, warmup: bool = True,
                 remeasure_cost: bool = False) -> None:
        """Drain-free rolling upgrade onto a successor table.

        The live table's logical content travels through its canonical
        in-memory image (``repro_torch.core.snapshot``) into a fresh table
        built for ``new_spec`` on ``device`` (default: the live table's
        device), or on ``mesh`` (a sharded ``new_spec``; every rank calls
        this). Without ``mesh`` in a mesh run the successor is a local
        replica on every rank and the router keeps the run's mesh. Queued
        and deferred requests are **retained verbatim**, in order,
        re-homed under the successor's shards, and complete against the
        successor; the zero-dropped invariant is checked here and tracked
        in ``metrics.dropped``. ``new_spec`` may change pool/depth sizing,
        lane width, backend, placement, shard count or mesh; an infeasible
        target raises ``ValueError`` before the swap, leaving the
        predecessor serving."""
        from repro_torch.core import snapshot

        depth_before = len(self.queues)
        image = snapshot.extract_image(self.table)
        self._emit("handover_begin", n_items=image.n_items,
                   queued=depth_before)
        successor = snapshot.restore_from_image(
            image, new_spec, self.table.device if device is None else device,
            mesh)
        self.table = successor
        if mesh is not None:
            self.mesh = mesh
        self.queues.rehome(new_spec)
        if warmup:
            # run the successor spec's dispatch shapes during the cutover,
            # not under the first post-upgrade requests
            self.warmup()
        if remeasure_cost and (successor.mesh is not None
                               or self.mesh is None):
            # a local replica in a mesh run keeps the agreed model: each
            # rank's own fit of it would differ
            self.cost_model = cost_model_for(successor)
        if len(self.queues) != depth_before:
            raise RuntimeError("handover dropped requests")
        self.metrics.handovers += 1
        # pressure is a property of the predecessor's layout; resample lazily
        self.pressure = 0.0
        self._emit("handover_end", n_items=image.n_items,
                   queued=len(self.queues))

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """Metrics snapshot + control-plane config (JSON-able)."""
        cfg = self.config
        out = self.metrics.snapshot(slo_p50_ms=cfg.slo_p50_ms,
                                    slo_p99_ms=cfg.slo_p99_ms)
        out["cost_model"] = {
            "base_s": self.cost_model.base_s,
            "chunk_s": self.cost_model.chunk_s,
            "n_lanes": self.cost_model.n_lanes,
            "source": self.cost_model.source,
            "batch_floor": self.batch_floor,
        }
        out["config"] = {
            "max_batch": cfg.max_batch,
            "max_queue_per_shard": cfg.max_queue_per_shard,
            "max_delay_s": cfg.max_delay_s,
            "pressure_defer": cfg.pressure_defer,
            "pressure_shed": cfg.pressure_shed,
        }
        out["queue_depths"] = self.queues.depths()
        out["pressure"] = round(self.pressure, 4)
        out["agreement_broadcasts"] = self.agreements
        return out


__all__ = ["Router", "RouterConfig"]
