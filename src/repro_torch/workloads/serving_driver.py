"""Closed-loop multi-client driver for the serving router.

The port of the JAX package's ``repro/workloads/serving_driver.py``, for
both placements. The churn engine's :mod:`~repro_torch.workloads.replay`
drives the facade with
pre-batched steps; this driver exercises the layer above it: ``n_clients``
independent clients each keep **one request in flight** (closed loop — a
client submits its next op only after the previous one completes), the
:class:`~repro_torch.serving.router.Router` re-batches the interleaved single-op
streams adaptively, and every admitted request is differentially checked
against the paper-literal sequential oracle in
:mod:`repro_torch.core.reference`.

The parity contract is order-sensitive and deferral-proof: the oracle is
replayed in the router's **linearization order** (the order requests come
back from dispatch — mutations in lane order, then reads), not submission
order. Admission control may shed a request (it then never reaches the
table *or* the oracle — the client retries after a backoff) and resize
backpressure may defer writes behind reads; both reorderings are exactly
what the linearization-order replay absorbs, so a mismatch is a real
serving-tier bug, not a scheduling artifact.

Time is a virtual clock: each driver iteration advances ``tick_s`` and
requests complete at ``dispatch_time + measured_service_seconds``, so
queue-wait statistics are deterministic given a seed while service times
stay real. ``handover_at`` re-seats the table under ``handover_spec``
mid-trace through the in-memory image path and the run asserts the
rolling-upgrade invariant: zero dropped requests, every post-handover
check still agreeing with the oracle that never stopped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.reference import SeqExtHash
from repro_torch.workloads.generators import LiveSet, OpMix, YCSB_MIXES
from repro_torch.workloads.replay import oracle_for


@dataclasses.dataclass
class _Client:
    """One closed-loop client: ready time + its private key stream."""

    rng: np.random.Generator
    remaining: int
    ready_t: float = 0.0
    next_fresh: int = 0


def _pick_op(client: _Client, mix: OpMix, live: LiveSet, key_base: int):
    """Sample one (kind, key, value) from the mix against the shared
    live-set model, mirroring the generator semantics: updates and deletes
    target live keys, inserts draw fresh keys from the client's private
    band, reads probe live keys with a guaranteed-absent probe band mixed
    in. The serving tier has no NOP channel, so noop mass folds into
    reads; live-key ops fall back to a fresh insert while the table is
    still empty."""
    from repro_torch.serving.router import DEL, INS, READ

    def fresh_insert():
        key = key_base + client.next_fresh
        client.next_fresh += 1
        return INS, key, int(client.rng.integers(1, 1 << 30))

    def live_key() -> int:
        return live.keys[int(client.rng.integers(len(live)))]

    p = mix.probs()
    r = float(client.rng.random())
    read_mass = p[0] + p[4]  # noop folds into read
    if r < read_mass:
        if live and client.rng.random() < 0.9:
            return READ, live_key(), 0
        # absent-probe band: above every fresh key the client will mint
        probe = key_base + (1 << 20) + int(client.rng.integers(1 << 20))
        return READ, probe, 0
    if r < read_mass + p[1]:  # update = upsert of a live key
        if not live:
            return fresh_insert()
        return INS, live_key(), int(client.rng.integers(1, 1 << 30))
    if r < read_mass + p[1] + p[2]:
        return fresh_insert()
    if not live:
        return fresh_insert()
    return DEL, live_key(), 0


def serve_closed_loop(
    spec,
    n_clients: int = 8,
    ops_per_client: int = 200,
    device=None,
    mix: OpMix | str = "churn",
    seed: int = 0,
    router_config=None,
    cost_model=None,
    tick_s: float = 1e-4,
    retry_backoff_s: float = 5e-4,
    check: bool = True,
    warmup: bool = True,
    handover_at: Optional[float] = None,
    handover_spec=None,
    max_examples: int = 8,
    mesh=None,
    handover_mesh=None,
) -> dict:
    """Run a closed-loop serving scenario on a fresh ``spec`` table on
    ``device`` (default ``"cuda"``), or on ``mesh`` (a sharded ``spec``;
    every rank of the mesh runs this, and the router agrees its service
    times over the mesh, so every rank serves the same stream alike);
    returns the router report extended with parity results.

    ``handover_at`` (a fraction of total ops in ``(0, 1)``) triggers one
    :meth:`Router.handover` onto ``handover_spec`` once that many requests
    have completed — with requests still queued, which is the point. The
    successor lives on the same device and may have another placement or
    shard count than ``spec``, at the same aggregate hash bits
    (``dmax + shard_bits``), which the oracle addresses. A sharded
    successor goes on ``handover_mesh`` (default ``mesh``); a local one is
    a replica on every rank of a mesh run.
    ``report["ok"]`` requires zero mismatches, zero drops, and every
    admitted request completed.
    """
    from repro_torch.serving.router import DEL, INS, Router, RouterConfig
    from repro_torch.table_api import Table

    if isinstance(mix, str):
        mix = YCSB_MIXES[mix]
    total_ops = n_clients * ops_per_client
    handover_due = int(total_ops * handover_at) if handover_at is not None else None
    if handover_due is not None:
        if handover_spec is None:
            raise ValueError("handover_at needs handover_spec")
        if not 0 < handover_due < total_ops:
            raise ValueError("handover_at must fall mid-trace")

    table = Table.create(spec, device, mesh)
    router = Router(
        table,
        router_config or RouterConfig(),
        cost_model=cost_model,
        clock=lambda: now,
    )
    if handover_spec is not None and handover_spec.placement == "sharded":
        handover_mesh = mesh if handover_mesh is None else handover_mesh
    else:
        handover_mesh = None
    if warmup:
        # run the dispatch shapes once so kernel builds and allocator
        # growth land in startup, not in the latency histograms
        router.warmup()
    ref: Optional[SeqExtHash] = (
        oracle_for(spec, "materializing") if check else None)

    ss = np.random.SeedSequence(seed)
    clients = [
        _Client(rng=np.random.default_rng(child), remaining=ops_per_client)
        for child in ss.spawn(n_clients)
    ]
    # the live-set model is shared (it models the one table all clients
    # hit); each client draws fresh insert keys from a private band
    live = LiveSet()
    key_band = 1 << 21

    now = 0.0
    in_flight = {}  # rid -> client index
    outstanding = [False] * n_clients
    status_mismatches = content_mismatches = 0
    examples: list = []
    completed_total = 0
    retries = 0
    did_handover = False

    def note(detail: dict) -> None:
        if len(examples) < max_examples:
            examples.append(detail)

    def absorb(done: List) -> None:
        """Fold completed requests back into clients + oracle, in the
        router's linearization order."""
        nonlocal completed_total, status_mismatches, content_mismatches
        for req in done:
            completed_total += 1
            ci = in_flight.pop(req.rid)
            outstanding[ci] = False
            clients[ci].ready_t = req.t_complete
            if req.kind == INS:
                live.add(req.key)
            elif req.kind == DEL:
                live.remove(req.key)
            if ref is None:
                continue
            if req.kind == INS:
                want = ref.insert(req.key, req.value)
                if req.status != want:
                    status_mismatches += 1
                    note(
                        {
                            "op": "ins",
                            "key": req.key,
                            "got": req.status,
                            "want": want,
                        }
                    )
            elif req.kind == DEL:
                want = ref.delete(req.key)
                if req.status != want:
                    status_mismatches += 1
                    note(
                        {
                            "op": "del",
                            "key": req.key,
                            "got": req.status,
                            "want": want,
                        }
                    )
            else:
                w_found, w_val = ref.lookup(req.key)
                got = (req.found, req.result if req.found else None)
                want = (w_found, w_val if w_found else None)
                if got != want:
                    content_mismatches += 1
                    note({"op": "read", "key": req.key, "got": got, "want": want})

    # main loop: submit-ready clients, pump, advance the virtual clock
    while any(c.remaining for c in clients) or len(router.queues):
        for ci, c in enumerate(clients):
            if c.remaining == 0 or outstanding[ci] or c.ready_t > now:
                continue
            kind, key, val = _pick_op(c, mix, live, key_band * (ci + 1))
            req, _decision = router.submit(kind, key, val, now=now)
            if req is None:
                retries += 1
                c.ready_t = now + retry_backoff_s
                continue
            in_flight[req.rid] = ci
            outstanding[ci] = True
            c.remaining -= 1
        absorb(router.pump(now=now))
        if (
            handover_due is not None
            and not did_handover
            and completed_total >= handover_due
        ):
            router.handover(handover_spec, mesh=handover_mesh)
            did_handover = True
        now += tick_s
    absorb(router.flush(now=now))

    report = router.report()
    report.update(
        {
            "n_clients": n_clients,
            "ops_per_client": ops_per_client,
            "mix": dataclasses.asdict(mix),
            "seed": seed,
            "checked": ref is not None,
            "status_mismatches": status_mismatches,
            "content_mismatches": content_mismatches,
            "mismatch_examples": examples,
            "retries_after_shed": retries,
            "handover_done": did_handover,
            "virtual_seconds": round(now, 6),
        }
    )
    if report["dropped"] or in_flight:
        raise RuntimeError(f"rolling upgrade dropped {report['dropped']} "
                           f"requests; {len(in_flight)} never completed")
    report["ok"] = (
        status_mismatches == 0
        and content_mismatches == 0
        and report["completed"] == report["admitted"]
        and report["dropped"] == 0
        and (did_handover or handover_due is None)
    )
    return report


__all__ = ["serve_closed_loop"]
