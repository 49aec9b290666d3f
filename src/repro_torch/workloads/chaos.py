"""Chaos replay harness: randomized fault injection over any scenario.

The port of the JAX package's ``repro/workloads/chaos.py``, for both
placements. The replayer (:mod:`repro_torch.workloads.replay`) checks that
a table under traffic agrees with the uninterrupted sequential oracle;
this module makes that check *adversarial*. A seed-deterministic event
schedule is overlaid on any registry scenario, and at each scheduled step
boundary the harness fires one injected fault against the live table
while the oracle — the surviving truth — runs uninterrupted:

* ``kill_revive``  — serialize to a durable on-disk image, drop the
  handle, restore under the same spec (the snapshot path);
* ``reshard``      — save/restore under a *different* geometry: local ↔
  sharded flips and shard-count changes (onto the meshes of
  ``mesh_for``, :func:`default_mesh_for` over the process group's ranks;
  or stacked, every shard on the table's one device, over the
  ``shard_counts`` the caller names) plus pool resizes. Candidates
  preserve the aggregate hash bits (``dmax + shard_bits``), so the
  oracle's group addressing never moves;
* ``policy_flap``  — rebuild the handle with a different
  :class:`~repro_torch.core.policy.ResizePolicy`: watermark band swaps,
  budget starvation, detach/reattach. Content-transparent by contract, so
  zero state copy — the spec is static metadata;
* ``backend_swap`` — rebuild the handle under another kernel backend
  (``plain`` / ``cuda`` / ``auto``); the plan re-resolves, the state
  tensors do not move;
* ``handover``     — route the table through a real
  :class:`repro_torch.serving.router.router.Router` and its zero-drop
  rolling ``handover()`` onto a successor geometry, recording the
  router's ``on_event`` stream;
* ``torn_save``    — install the snapshot fault hook
  (:func:`repro_torch.core.snapshot.set_fault_hook`), interrupt an image
  overwrite *before* its atomic rename, prove the destination still holds
  the intact predecessor image, and revive from it.

After **every** event the harness re-checks the per-shard structural
invariants (:mod:`repro_torch.core.invariants`) and full-content parity: the
digest of the table's canonical snapshot image must equal the streaming
oracle's rolling multiset digest. Between events, every per-lane status
and every read is checked in linearization order exactly as in plain
replay.

Failing seeds reproduce from the command line and shrink::

    python -m repro_torch.workloads.chaos --scenario chaos_reshard --seed 17

Under ``torchrun`` (or with ``RANK`` / ``WORLD_SIZE`` set and
``--dist-init file:///path`` for gloo ranks on the CPU) every rank runs
the same seeds on meshes of the process group's ranks
(``--placement sharded`` starts on ``default_mesh_for(n_shards)``), and
rank 0 alone prints and writes the artifact::

    torchrun --nproc-per-node 4 -m repro_torch.workloads.chaos \\
        --scenario chaos_reshard --placement sharded --seed 5

On failure the schedule is reduced to a minimal failing prefix (binary
search for the shortest failing prefix, then greedy single-event
elimination — ddmin-style, exact under monotone failures) and a JSON
artifact with the original schedule, the shrunk schedule, and the repro
command is written for CI to upload.

Everything is deterministic in ``(scenario, placement, seed, scale)``:
the op stream comes from the trace seed, the event schedule from
:func:`gen_schedule` on the same seed, and event parameters from each
event's ``arg`` — no wall-clock, no default-constructed RNGs. The table
runs on ``"cuda"`` unless the caller names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import ResizePolicy
from repro_torch.core.reference import content_digest
from repro_torch.workloads.generators import DEL, INS, NOP
from repro_torch.workloads.replay import ReplayMismatch, oracle_for
from repro_torch.workloads.scenarios import POLICY, get_scenario
from repro_torch.workloads.trace import gen_steps

EVENT_KINDS = (
    "kill_revive",
    "reshard",
    "policy_flap",
    "backend_swap",
    "handover",
    "torn_save",
)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled injection: fires before step index ``step`` (0-based).

    ``arg`` deterministically selects the event's parameters (which
    re-shard candidate, which policy variant, ...) via modular indexing —
    the schedule alone fully reproduces a run."""

    step: int
    kind: str
    arg: int = 0


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Schedule-generation knobs (see :func:`gen_schedule`)."""

    n_events: int = 8
    kinds: Tuple[str, ...] = EVENT_KINDS
    seed: int = 0


def gen_schedule(total_steps: int, config: ChaosConfig) -> Tuple[ChaosEvent, ...]:
    """Deterministic randomized schedule of ``config.n_events`` events.

    Steps are drawn uniformly over the trace interior; the first
    ``len(kinds)`` events cycle a seeded permutation of the enabled kinds,
    so every requested fault type fires at least once whenever
    ``n_events >= len(kinds)`` (the acceptance criterion's "≥ 3 distinct
    event types" is guaranteed by construction, not luck)."""
    for k in config.kinds:
        if k not in EVENT_KINDS:
            raise ValueError(f"unknown chaos event kind {k!r}")
    if config.n_events < 0:
        raise ValueError(f"n_events must be >= 0, got {config.n_events}")
    rng = np.random.default_rng([config.seed, 0xC7A05])
    kinds = list(config.kinds)
    perm = rng.permutation(len(kinds))
    chosen = [
        kinds[perm[i % len(kinds)]]
        if i < len(kinds)
        else kinds[int(rng.integers(len(kinds)))]
        for i in range(config.n_events)
    ]
    steps = sorted(
        int(s) for s in rng.integers(1, max(2, total_steps), config.n_events)
    )
    args = [int(a) for a in rng.integers(0, 1 << 30, config.n_events)]
    return tuple(
        ChaosEvent(step=s, kind=k, arg=a) for s, k, a in zip(steps, chosen, args)
    )


# ---------------------------------------------------------------------------
# event parameter candidates (all derived from the current spec + ``arg``)


def _agg_bits(spec) -> int:
    return spec.dmax + (spec.shard_bits if spec.placement == "sharded" else 0)


def _mesh_shape(n_shards: int, n_lanes: int, world: int):
    """``(data, model)`` of :func:`default_mesh_for`'s mesh over ``world``
    ranks, or None (a table's shard count is a power of two)."""
    if n_shards < 2 or n_shards & (n_shards - 1):
        return None
    model = math.gcd(world, n_shards)
    data = world // model
    if n_lanes % data:
        return None
    return data, model


# meshes by (shape, device type), each beside the process group it was
# built over: an N -> M move back onto a shape reuses its communicators
_MESHES: Dict[Tuple, Tuple[object, object]] = {}


def default_mesh_for(n_shards: int, n_lanes: int = 16,
                     device_type: str = "cuda"):
    """Mesh factory over this process group's ranks, the counterpart of
    the JAX package's (one process a rank; every rank calls it): a
    ``(data, model)`` mesh with ``model = gcd(world, n_shards)`` and
    ``data = world / model`` (``launch/mesh.py::make_local_mesh``), or
    None for fewer than 2 shards or when ``data`` does not divide
    ``n_lanes`` (the candidate is skipped). Where the JAX factory returns a
    mesh for the same device count the shape is the same; where it
    returns None for want of devices, this one puts ``n_shards / model``
    shards on each rank (``TableSpec.check_mesh``). Without a process
    group the world is one rank, and ``make_local_mesh`` starts its group.
    Meshes are cached per shape and process group;
    ``default_mesh_for.builds`` counts the ones built."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = _mesh_shape(n_shards, n_lanes, world)
    if shape is None:
        return None
    key = (shape, device_type)
    hit = _MESHES.get(key)
    if (hit is not None and dist.is_initialized()
            and hit[0] is dist.group.WORLD):
        return hit[1]
    mesh = make_local_mesh(model=shape[1], data=shape[0],
                           device_type=device_type)
    default_mesh_for.builds += 1
    _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


default_mesh_for.builds = 0


def _respec_candidates(spec, mesh=None, mesh_for=None,
                       shard_counts=None) -> List[Tuple[object, object]]:
    """Successor ``(spec, mesh)`` pairs for reshard/handover events, the
    JAX package's list in its order: local at the aggregate bits with two
    pool sizes (no mesh), then 2 / 4 / 8 shards at ``bits - shard_bits``
    with two pool sizes, each on ``mesh_for(n_shards)`` (skipped where it
    returns None). Without ``mesh_for``, ``shard_counts`` (powers of two)
    names the shard counts of stacked candidates (every shard on the
    table's one device; the JAX package's 8-device factory hosts 2 / 4 /
    8); without either a sharded table keeps its shard count and mesh and
    varies only the pool. Every candidate preserves the aggregate hash
    bits, so a local dmax=b table, a 2-shard dmax=b-1 table and a 4-shard
    dmax=b-2 table are all the same logical address space — the oracle
    never needs to re-bit."""
    bits = _agg_bits(spec)
    pools = (spec.pool_size, spec.pool_size + 256)
    out = [(dataclasses.replace(spec, placement="local", dmax=bits,
                                pool_size=pool), None) for pool in pools]

    def sharded(sb, m):
        return [(dataclasses.replace(spec, placement="sharded",
                                     shard_bits=sb, dmax=bits - sb,
                                     pool_size=pool), m) for pool in pools]

    if mesh_for is not None:
        for sb in (1, 2, 3):
            if bits - sb < 1:
                continue
            m = mesh_for(1 << sb)
            if m is not None:
                out += sharded(sb, m)
    elif shard_counts is not None:
        for n in shard_counts:
            sb = n.bit_length() - 1
            if n < 2 or n != 1 << sb:
                raise ValueError(f"shard count {n} is not a power of two "
                                 f">= 2")
            if bits - sb >= 1:
                out += sharded(sb, None)
    elif spec.placement == "sharded":
        out += [(dataclasses.replace(spec, pool_size=pool), mesh)
                for pool in pools]
    return out


def _policy_candidates(spec) -> Tuple[Optional[ResizePolicy], ...]:
    base = spec.resize_policy or POLICY
    return (
        None,  # detach: paper-reactive splits only
        base,  # reattach the scenario policy
        ResizePolicy(0.625, 0.25, max_splits=8, max_merges=4),  # eager band
        ResizePolicy(1.0, 0.5, max_splits=4, max_merges=2),  # lazy band
        dataclasses.replace(base, max_splits=1, max_merges=1),  # starved
    )


def _backend_candidates(spec) -> Tuple[str, ...]:
    return ("plain", "cuda", "auto")


# ---------------------------------------------------------------------------
# scenario setup (sizing for op targets)


def chaos_setup(
    name: str,
    placement: str = "local",
    seed: int = 0,
    scale: float = 1.0,
    ops: Optional[int] = None,
    kinds: Sequence[str] = EVENT_KINDS,
    n_events: Optional[int] = None,
):
    """Resolve ``(spec, trace, schedule)`` for a chaos run.

    ``ops`` sets a minimum op-slot target by stretching ``scale``; long
    runs additionally get capacity-aware sizing — a wider key universe
    and deeper hash bits with ~2 levels of headroom over the peak live
    set (keeping worst-case hash groups far below ``bucket_size``, so
    OVERFLOW stays a non-event) and a bucket pool sized for that peak.
    Aggregate bits are raised symmetrically for both placements."""
    if ops is not None:
        _, base_trace = get_scenario(name, placement=placement, seed=seed)
        base_est = sum(p.steps * p.batch for p in base_trace.phases)
        scale = max(scale, ops / base_est)
    spec, trace = get_scenario(name, placement=placement, seed=seed,
                               scale=scale)
    est = sum(p.steps * p.batch for p in trace.phases)
    if est > 4096:
        # beyond the peak floor the base registry geometry can absorb,
        # re-provision for the stretched trace.
        # peak live set ~ half the op slots (insert-heavy churn traces);
        # hash bits get ~2 levels of headroom over that peak — the same
        # doctrine as scenarios._spec — so worst-case hash groups stay far
        # below bucket_size and OVERFLOW remains a non-event
        peak = max(4096, est // 2)
        bits = max(_agg_bits(spec), math.ceil(math.log2(8 * peak)))
        extra = spec.shard_bits if spec.placement == "sharded" else 0
        spec = dataclasses.replace(
            spec, dmax=bits - extra,
            pool_size=max(spec.pool_size, -(-peak // 2)))
        trace = dataclasses.replace(trace,
                                    universe=max(trace.universe, 1 << bits))
    if n_events is None:
        n_events = max(len(kinds), min(24, trace.total_steps // 10))
    config = ChaosConfig(n_events=n_events, kinds=tuple(kinds), seed=seed)
    return spec, trace, gen_schedule(trace.total_steps, config)


# ---------------------------------------------------------------------------
# the chaos replay loop


def chaos_replay(
    spec,
    trace,
    schedule: Sequence[ChaosEvent],
    device=None,
    mesh=None,
    mesh_for: Optional[Callable[[int], object]] = None,
    shard_counts: Optional[Sequence[int]] = None,
    check: bool = True,
    oracle: str = "streaming",
    raise_on_mismatch: bool = True,
    max_examples: int = 8,
    depth_every: int = 4,
    _inject_digest_step: Optional[int] = None,
) -> dict:
    """Replay ``trace`` on a fresh ``spec`` table on ``device`` (default
    ``"cuda"``), or on ``mesh``, while firing ``schedule``'s events
    between steps.

    Differential checks mirror :func:`repro_torch.workloads.replay.replay`
    (per-lane statuses and per-read parity in linearization order against
    the uninterrupted oracle); additionally, after every fired event the
    harness checks the structural invariants and digest-exact content
    parity. ``oracle`` is ``"streaming"`` (default — O(1)/op, so
    million-op chaos traces stay checkable) or ``"both"`` (adds the
    materializing cross-check per op). ``mesh_for(n_shards)`` supplies
    meshes for cross-placement re-shard candidates
    (:func:`default_mesh_for`); without it, ``shard_counts`` (e.g. ``(2,
    4, 8)``) are the shard counts stacked candidates may take; without
    either, re-shards keep the placement and shard count and change the
    pool.

    On a mesh of ranks every rank runs this with the same arguments: the
    work directory is rank 0's (``replay.py::_shared_dir``), global rank 0
    alone writes each image (a local table is then a replica on every
    rank, saved once), restores and handovers land on the successor's mesh,
    the error flag and the checks read the whole table, and every rank
    returns the same report. The run's mesh is ``mesh``, or for a run that
    starts local the first of ``mesh_for``'s.

    ``_inject_digest_step`` is a self-test knob: it corrupts the oracle
    digest after the given step so the failure/shrink/artifact path can be
    exercised on demand (used by ``--self-test-fail`` and the tests)."""
    from repro_torch.core import invariants as I
    from repro_torch.core import snapshot as S
    from repro_torch.table_api import Table
    from repro_torch.workloads.replay import _shared_dir

    if spec.value_schema is not None:
        raise ValueError("chaos drives the raw i32 value mode")
    if oracle not in ("streaming", "both"):
        raise ValueError(f"oracle {oracle!r} not in ('streaming', 'both')")

    refs: list = []
    if check:
        if oracle == "both":
            refs.append(oracle_for(spec, "materializing"))
        refs.append(oracle_for(spec, "streaming"))
    stream_ref = refs[-1] if refs else None

    table = Table.create(spec, device, mesh)
    device = table.device
    run_mesh = mesh
    if run_mesh is None and mesh_for is not None:
        run_mesh = next((m for m in map(mesh_for, (2, 4, 8))
                         if m is not None), None)
    base_agg = _agg_bits(spec)
    error_seen = False
    steps = mutations = reads = 0
    status_mismatches = content_mismatches = 0
    examples: list = []
    depth_traj = [int(table.depth())]
    increases = decreases = 0
    event_records: List[dict] = []
    pending = sorted(schedule, key=lambda e: e.step)
    next_ev = 0

    def note(kind: str, detail) -> None:
        nonlocal status_mismatches, content_mismatches
        if kind == "status":
            status_mismatches += 1
        else:
            content_mismatches += 1
        if len(examples) < max_examples:
            examples.append({"kind": kind, "detail": detail})
        if raise_on_mismatch:
            raise ReplayMismatch(f"{kind} mismatch: {detail}")

    def flag() -> bool:
        # any shard's, reduced over a mesh table's ranks
        return bool(table._error())

    def save(path: str) -> str:
        # one writer: rank 0 on a mesh table or a replica in a mesh run
        return table.save(path, run_mesh)

    def rebuild(new_spec) -> None:
        # policy flaps and backend swaps are content-transparent: same
        # state tensors, new static metadata — no copy, no device work
        nonlocal table, spec
        table = Table(new_spec, table.device, table.state, table.slabs,
                      table.slab_live, table.seq, table.mesh)
        spec = new_spec

    def post_event_checks(rec: dict) -> None:
        # a stacked sharded state is checked shard by shard: the rank's
        # own shards, and on a mesh the whole gathered stack too
        I.check_invariants(spec.table_config(), table.state, allow_error=True)
        if table.mesh is not None:
            I.check_invariants(spec.table_config(), I.full_view(table),
                               allow_error=True)
        rec["invariant_shards"] = spec.n_shards
        if stream_ref is not None:
            image = S.extract_image(table)
            got = content_digest(image.keys, image.values)
            rec["digest_ok"] = got == stream_ref.digest
            rec["n_items"] = image.n_items
            if not rec["digest_ok"]:
                note(
                    "content",
                    {
                        "event": rec["kind"],
                        "step": rec["step"],
                        "digest": got,
                        "want": stream_ref.digest,
                        "n_items": image.n_items,
                        "want_items": stream_ref.size,
                    },
                )

    def fire(ev: ChaosEvent, workdir: str, idx: int) -> None:
        nonlocal table, spec, mesh, error_seen
        rec: Dict[str, object] = {
            "step": steps,
            "kind": ev.kind,
            "arg": ev.arg,
            "skipped": False,
        }
        if ev.kind == "kill_revive":
            error_seen |= flag()
            path = save(os.path.join(workdir, f"ev{idx}.npz"))
            del table
            table = Table.restore(path, spec, device, mesh)
        elif ev.kind in ("reshard", "handover"):
            cands = _respec_candidates(spec, mesh, mesh_for, shard_counts)
            new_spec, new_mesh = cands[ev.arg % len(cands)]
            if _agg_bits(new_spec) != base_agg:
                raise AssertionError(f"{new_spec} moved off {base_agg} bits")
            rec["to"] = {
                "placement": new_spec.placement,
                "shard_bits": new_spec.shard_bits,
                "dmax": new_spec.dmax,
                "pool_size": new_spec.pool_size,
            }
            error_seen |= flag()
            if ev.kind == "reshard":
                path = save(os.path.join(workdir, f"ev{idx}.npz"))
                try:
                    table = Table.restore(path, new_spec, device, new_mesh)
                    spec, mesh = new_spec, new_mesh
                except ValueError as e:  # infeasible target: predecessor lives on
                    rec["skipped"] = True
                    rec["reason"] = str(e)[:200]
            else:
                from repro_torch.serving.router.costmodel import (
                    default_cost_model)
                from repro_torch.serving.router.router import (Router,
                                                               RouterConfig)

                seen: List[str] = []
                router = Router(
                    table,
                    RouterConfig(),
                    cost_model=default_cost_model(spec.n_lanes),
                    clock=lambda: 0.0,
                    on_event=lambda name, info: seen.append(name),
                )
                try:
                    router.handover(new_spec, mesh=new_mesh, warmup=False)
                except ValueError as e:
                    rec["skipped"] = True
                    rec["reason"] = str(e)[:200]
                    table = router.table  # unchanged: handover failed pre-swap
                else:
                    table = router.table
                    spec, mesh = new_spec, new_mesh
                    if not (router.metrics.handovers == 1
                            and router.metrics.dropped == 0
                            and "handover_begin" in seen
                            and "handover_end" in seen):
                        raise AssertionError(
                            f"handover: {router.metrics}, events {seen}")
                    rec["router_events"] = seen
        elif ev.kind == "policy_flap":
            cands = _policy_candidates(spec)
            pol = cands[ev.arg % len(cands)]
            rec["policy"] = (
                None
                if pol is None
                else {
                    "split_watermark": pol.split_watermark,
                    "merge_watermark": pol.merge_watermark,
                    "max_splits": pol.max_splits,
                    "max_merges": pol.max_merges,
                }
            )
            rebuild(dataclasses.replace(spec, resize_policy=pol))
        elif ev.kind == "backend_swap":
            cands = _backend_candidates(spec)
            backend = cands[ev.arg % len(cands)]
            rec["backend"] = backend
            rebuild(dataclasses.replace(spec, backend=backend))
        elif ev.kind == "torn_save":
            path = os.path.join(workdir, f"ev{idx}_torn.npz")
            save(path)  # intact victim image
            want = S.load_image(path)
            want_digest = content_digest(want.keys, want.values)

            def boom(point, _path):
                if point == "pre_rename":
                    raise S.InjectedFault(
                        f"injected crash before rename of {_path}")

            prev = S.set_fault_hook(boom)
            torn = False
            try:
                try:
                    save(path)  # overwrite attempt dies mid-save
                except S.InjectedFault:
                    torn = True
            finally:
                S.set_fault_hook(prev)
            if not torn:
                raise AssertionError("fault hook did not fire")
            survivor = S.load_image(path)
            got_digest = content_digest(survivor.keys, survivor.values)
            rec["image_intact"] = got_digest == want_digest
            if not rec["image_intact"]:
                note(
                    "content",
                    {
                        "event": "torn_save",
                        "step": steps,
                        "digest": got_digest,
                        "want": want_digest,
                    },
                )
            error_seen |= flag()
            del table
            # revive from the survivor
            table = Table.restore(path, spec, device, mesh)
        else:  # pragma: no cover - gen_schedule validates kinds
            raise ValueError(f"unknown chaos event kind {ev.kind!r}")
        post_event_checks(rec)
        event_records.append(rec)
        if ev.kind in ("reshard", "handover") and not rec["skipped"]:
            # placements disagree on per-shard depth: re-baseline the
            # trajectory so the jump is not miscounted as elasticity
            depth_traj.append(int(table.depth()))

    with _shared_dir(run_mesh) as workdir:
        for step in gen_steps(trace):
            while next_ev < len(pending) and pending[next_ev].step <= steps:
                fire(pending[next_ev], workdir, next_ev)
                next_ev += 1
            steps += 1

            m = int(step.kinds.shape[0])
            if m:
                table, res = table.apply(step.kinds, step.keys, step.vals)
                mutations += step.n_mutations
                if refs:
                    got = res.status.cpu().numpy()
                    for lane in range(m):
                        kind = int(step.kinds[lane])
                        if kind == NOP:
                            continue
                        key = int(step.keys[lane])
                        if kind == INS:
                            val = int(step.vals[lane])
                            wants = [r.insert(key, val) for r in refs]
                        else:
                            assert kind == DEL
                            wants = [r.delete(key) for r in refs]
                        if len(wants) == 2 and wants[0] != wants[1]:
                            raise ReplayMismatch(
                                f"oracle divergence at step {steps} lane "
                                f"{lane}: materializing={wants[0]} "
                                f"streaming={wants[1]} (key {key})"
                            )
                        if int(got[lane]) != wants[0]:
                            note(
                                "status",
                                {
                                    "step": steps,
                                    "lane": lane,
                                    "op": "ins" if kind == INS else "del",
                                    "key": key,
                                    "got": int(got[lane]),
                                    "want": wants[0],
                                },
                            )

            r = int(step.reads.shape[0])
            if r:
                found, vals = table.lookup(step.reads)
                reads += r
                if refs:
                    found = found.cpu().numpy()
                    vals = vals.cpu().numpy()
                    for i in range(r):
                        key = int(step.reads[i])
                        wants = [ref.lookup(key) for ref in refs]
                        if len(wants) == 2 and wants[0] != wants[1]:
                            raise ReplayMismatch(
                                f"oracle divergence at step {steps} read "
                                f"{i}: materializing={wants[0]} "
                                f"streaming={wants[1]} (key {key})"
                            )
                        w_found, w_val = wants[0]
                        got_f, got_v = bool(found[i]), int(vals[i])
                        if got_f != w_found or (w_found and got_v != w_val):
                            note(
                                "content",
                                {
                                    "step": steps,
                                    "key": key,
                                    "got": (got_f, got_v),
                                    "want": (w_found, w_val),
                                },
                            )

            if (
                _inject_digest_step is not None
                and steps == _inject_digest_step
                and stream_ref is not None
            ):
                # self-test: plant a phantom pair far outside the trace's
                # key universe so digest and size diverge from the table
                # permanently; statuses only consult real keys and group
                # counts, so the run keeps going and the failure surfaces
                # at the next content check
                stream_ref.items[-(1 << 40) - 13] = 1
                stream_ref._dirty = True

            if depth_every and steps % depth_every == 0:
                d = int(table.depth())
                if d > depth_traj[-1]:
                    increases += 1
                elif d < depth_traj[-1]:
                    decreases += 1
                depth_traj.append(d)

        # events scheduled at/after the last step fire at end of trace
        while next_ev < len(pending):
            fire(pending[next_ev], workdir, next_ev)
            next_ev += 1

        # final content parity: canonical image digest vs the oracle
        if stream_ref is not None:
            image = S.extract_image(table)
            got = content_digest(image.keys, image.values)
            if got != stream_ref.digest:
                note(
                    "content",
                    {
                        "final_digest": got,
                        "want": stream_ref.digest,
                        "n_items": image.n_items,
                        "want_items": stream_ref.size,
                    },
                )
            elif image.n_items != stream_ref.size:
                note("content", {"final_size": image.n_items,
                                 "want": stream_ref.size})

    stats = table.policy_stats()
    fired = [r for r in event_records if not r["skipped"]]
    counts: Dict[str, int] = {}
    for r in fired:
        counts[str(r["kind"])] = counts.get(str(r["kind"]), 0) + 1
    report = {
        "trace": trace.name,
        "placement": spec.placement,
        "backend": spec.backend,  # final backend (swaps may move it)
        "device": str(device),
        "steps": steps,
        "mutations": mutations,
        "reads": reads,
        "checked": stream_ref is not None,
        "oracle": oracle if stream_ref is not None else None,
        "status_mismatches": status_mismatches,
        "content_mismatches": content_mismatches,
        "mismatch_examples": examples,
        "depth": {
            "start": depth_traj[0],
            "max": max(depth_traj),
            "final": depth_traj[-1],
            "increases": increases,
            "decreases": decreases,
            "trajectory": depth_traj,
        },
        "policy": {
            "splits": int(stats["splits"]),
            "merges": int(stats["merges"]),
        },
        "error_flag": error_seen | flag(),
        "schedule": [[e.step, e.kind, e.arg] for e in pending],
        "events": event_records,
        "event_counts": counts,
        "events_fired": len(fired),
        "events_skipped": len(event_records) - len(fired),
    }
    report["ok"] = (
        status_mismatches == 0
        and content_mismatches == 0
        and not report["error_flag"]
        and all(r.get("digest_ok", True) for r in event_records)
    )
    return report


# ---------------------------------------------------------------------------
# schedule shrinking (failing-seed minimization)


def shrink_schedule(
    fails: Callable[[Tuple[ChaosEvent, ...]], bool],
    schedule: Sequence[ChaosEvent],
) -> Tuple[ChaosEvent, ...]:
    """Reduce ``schedule`` to a small still-failing event subsequence.

    ``fails(events)`` must deterministically report whether the run fails
    under exactly those events. Strategy: binary-search the shortest
    failing prefix (exact when failure is prefix-monotone, a safe
    over-approximation otherwise), then greedily drop single events from
    the back. The result always satisfies ``fails(result)``; an empty
    result means the trace fails with no events at all (the fault is not
    event-induced)."""
    events = tuple(sorted(schedule, key=lambda e: e.step))
    if not fails(events):
        raise ValueError("shrink_schedule: the full schedule does not fail")
    lo, hi = 0, len(events)
    while lo < hi:
        mid = (lo + hi) // 2
        if fails(events[:mid]):
            hi = mid
        else:
            lo = mid + 1
    events = events[:hi]
    i = len(events) - 1
    while i >= 0:
        cand = events[:i] + events[i + 1 :]
        if fails(cand):
            events = cand
        i -= 1
    return events


# ---------------------------------------------------------------------------
# failing-seed reproducer CLI


def _summary(rep: dict) -> str:
    return (
        f"ok={rep['ok']} steps={rep['steps']} "
        f"ops={rep['mutations'] + rep['reads']} "
        f"events={rep['events_fired']}({rep['events_skipped']} skipped) "
        f"kinds={sorted(rep['event_counts'])} "
        f"status_mm={rep['status_mismatches']} "
        f"content_mm={rep['content_mismatches']} "
        f"depth={rep['depth']['start']}->{rep['depth']['max']}"
        f"->{rep['depth']['final']} "
        f"splits={rep['policy']['splits']} merges={rep['policy']['merges']}"
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads.chaos",
        description="chaos replay: fault-injection differential testing "
        "(see module docstring)",
    )
    ap.add_argument("--scenario", default="chaos_churn")
    ap.add_argument("--placement", default="local",
                    choices=("local", "sharded"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the table (default cuda)")
    ap.add_argument("--seed", type=int, default=0, help="first seed")
    ap.add_argument("--seeds", type=int, default=1, help="number of seeds to run")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--ops", type=int, default=None, help="min op-slot target")
    ap.add_argument("--events", type=int, default=None, help="schedule length")
    ap.add_argument(
        "--kinds", default=",".join(EVENT_KINDS), help="comma list of event kinds"
    )
    ap.add_argument("--oracle", default="streaming", choices=("streaming", "both"))
    ap.add_argument(
        "--shrink",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="on failure, shrink the schedule to a minimal failing prefix",
    )
    ap.add_argument(
        "--artifact",
        default="chaos_failure.json",
        help="where to write the failing-seed artifact",
    )
    ap.add_argument("--dist-init", default="env://",
                    help="process-group init method when RANK and "
                    "WORLD_SIZE are set: env:// (torchrun) or file:///path")
    ap.add_argument("--self-test-fail", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    spec0, _, _ = chaos_setup(args.scenario, placement=args.placement,
                              seed=args.seed)
    started, device = _start_group(args.device, args.dist_init)
    try:
        return _cli_runs(args, kinds, spec0, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _start_group(device: str, init_method: str):
    """``(started, device)``: with ``RANK`` / ``WORLD_SIZE`` set, a
    process group started here as ``launch/train.py`` starts one (NCCL on
    ``cuda:LOCAL_RANK``, gloo otherwise); a group already started is used
    as it is; with neither, no group."""
    import torch
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda" and (dist.is_initialized() or "RANK" in os.environ):
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(torch.device(device))
    if dist.is_initialized() or "RANK" not in os.environ:
        return False, device
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=init_method,
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True, device


def _cli_runs(args, kinds, spec0, device) -> int:
    """The CLI's seeds: on meshes of the process group's ranks when one is
    up (rank 0 alone prints and writes the artifact), else stacked."""
    import torch
    import torch.distributed as dist

    mesh = mesh_for = None
    lead = True
    if dist.is_initialized():
        kind = torch.device(device).type
        lead = dist.get_rank() == 0

        def mesh_for(n):
            return default_mesh_for(n, spec0.n_lanes, kind)

        if args.placement == "sharded":
            mesh = mesh_for(spec0.n_shards)
            if mesh is None:
                if lead:
                    print(f"[chaos] cannot lay {spec0.n_shards} shards of "
                          f"{spec0.n_lanes} lanes on "
                          f"{dist.get_world_size()} ranks", file=sys.stderr)
                return 2
    failures = []
    for seed in range(args.seed, args.seed + args.seeds):
        spec, trace, schedule = chaos_setup(
            args.scenario,
            placement=args.placement,
            seed=seed,
            scale=args.scale,
            ops=args.ops,
            kinds=kinds,
            n_events=args.events,
        )

        def run(events):
            return chaos_replay(
                spec,
                trace,
                events,
                device=device,
                mesh=mesh,
                mesh_for=mesh_for,
                # stacked, every shard count the JAX package's 8-device
                # mesh factory hosts is hostable on the one device
                shard_counts=(2, 4, 8),
                oracle=args.oracle,
                raise_on_mismatch=False,
                _inject_digest_step=args.self_test_fail,
            )

        rep = run(schedule)
        if lead:
            print(f"[chaos] {args.scenario}/{args.placement}/"
                  f"{rep['device']} seed={seed}: {_summary(rep)}")
        if rep["ok"]:
            continue
        failures.append(seed)
        shrunk = None
        if args.shrink:
            # every rank shrinks: each trial run is collective on a mesh
            shrunk = shrink_schedule(lambda evs: not run(evs)["ok"], schedule)
            if lead:
                print(f"[chaos] seed {seed} shrunk: {len(schedule)} -> "
                      f"{len(shrunk)} events: "
                      f"{[[e.step, e.kind, e.arg] for e in shrunk]}")
        if not lead:
            continue
        artifact = {
            "scenario": args.scenario,
            "placement": args.placement,
            "device": args.device,
            "seed": seed,
            "scale": args.scale,
            "ops": args.ops,
            "kinds": list(kinds),
            "repro": (
                f"python -m repro_torch.workloads.chaos --scenario "
                f"{args.scenario} --placement {args.placement} "
                f"--device {args.device} --seed {seed} --scale {args.scale}"
                + (f" --ops {args.ops}" if args.ops else "")
                + (f" --events {args.events}" if args.events else "")
            ),
            "schedule": [[e.step, e.kind, e.arg] for e in schedule],
            "shrunk_schedule": (
                None if shrunk is None else [[e.step, e.kind, e.arg] for e in shrunk]
            ),
            "report": {k: v for k, v in rep.items() if k != "depth"},
            "depth": {k: v for k, v in rep["depth"].items() if k != "trajectory"},
        }
        with open(args.artifact, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[chaos] wrote failing-seed artifact to {args.artifact}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
