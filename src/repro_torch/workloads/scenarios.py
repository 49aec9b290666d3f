"""Named scenario registry: the sweep axis of the replay tests.

The JAX package's registry (``repro/workloads/scenarios.py``) on the
port's ``TableSpec`` and ``ResizePolicy``: the same names, traces, specs
and ``POLICY``. Each scenario couples a :class:`Trace` (what traffic looks
like) with the :class:`TableSpec` knobs it is meant to stress (how the
table is built), for either placement. The classes:

* ``uniform``      — uniform keys, YCSB-A mix: the paper's directory-stable
  regime, policy mostly idle (baseline sanity);
* ``zipf``         — Zipf-skewed YCSB-B: a stable hot set concentrates
  occupancy, driving proactive splits on the hot region only;
* ``phased_drain`` — fill -> stable -> drain -> maintain -> refill: the
  full elastic round trip (depth must rise, then *fall* — the first
  runtime exercise of the paper's §4.5 merge path);
* ``mixed_churn``  — alternating growth/shrink bursts with skewed reads:
  the resize-heavy regime where both policy directions fire repeatedly;
* ``snapshot_restore`` — kills and revives the table twice mid-trace
  through a durable on-disk image (phases named ``snapshot_restore*``
  trigger the revive in the replayer): once at peak occupancy with growth
  traffic after it, once followed by a drain — the revived table must
  keep auto-splitting AND auto-merging, and every post-revive check is
  differential parity evidence for the snapshot subsystem;
* ``chaos_churn`` / ``chaos_reshard`` — the fault-injection substrate of
  the chaos harness (``workloads/chaos.py``): long
  multi-direction churn traces whose
  phase plateaus give injected events (kill/revive, N→M re-shard, policy
  flaps, router handover, torn saves, backend swaps) a full spread of
  occupancy regimes to land in. Replayed plain they are ordinary parity
  scenarios; the chaos engine overlays a seed-deterministic event
  schedule (``chaos_reshard`` leans on drain→refill plateaus so
  re-shards hit both a shrinking and a growing directory).

Scenarios are deterministic in (name, placement, seed); ``scale`` stretches
step counts for benchmark runs without touching the op stream's shape.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.core.policy import ResizePolicy
from repro_torch.core.spec import TableSpec
from repro_torch.workloads.trace import Phase, Trace

# one policy everywhere: B=8 -> split at 6 items, merge when a buddy pair
# holds <= 3 items; budgets sized so a 16-lane transaction can always keep
# up with the batch it just applied
POLICY = ResizePolicy(
    split_watermark=0.75,
    merge_watermark=0.375,
    max_splits=8,
    max_merges=4,
)

_BATCH = 48
_UNIVERSE = 1 << 14


def _spec(placement: str, policy: bool) -> TableSpec:
    """The table under test: same aggregate capacity for both placements
    (a sharded table's shard id consumes hash bits, so per-shard dmax
    shrinks by shard_bits)."""
    sharded = placement == "sharded"
    # dmax sized with ~2 levels of headroom over the proactive-split depth
    # (~log2(keys / split_threshold)) so dense hash tails never exhaust
    # their key bits: scenarios must exercise resizing, not OVERFLOW
    return TableSpec(
        dmax=9 if sharded else 10,
        bucket_size=8,
        pool_size=768,
        n_lanes=16,
        placement=placement,
        shard_bits=1,
        resize_policy=POLICY if policy else None,
    )


def _scaled(phases: Tuple[Phase, ...], scale: float) -> Tuple[Phase, ...]:
    if scale == 1.0:
        return phases
    return tuple(
        Phase(
            name=p.name,
            steps=max(1, math.ceil(p.steps * scale)),
            mix=p.mix,
            dist=p.dist,
            theta=p.theta,
            batch=p.batch,
        )
        for p in phases
    )


def _uniform_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 22, "fill", batch=_BATCH),
        Phase("stable", 18, "A", dist="uniform", batch=_BATCH),
        Phase("read_latest", 8, "D", dist="latest", batch=_BATCH),
    )


def _zipf_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 18, "fill", batch=_BATCH),
        Phase("hot_b", 22, "B", dist="zipf", theta=0.99, batch=_BATCH),
        Phase("hot_a", 10, "A", dist="zipf", theta=0.99, batch=_BATCH),
    )


def _phased_drain_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 24, "fill", batch=_BATCH),
        Phase("stable", 10, "A", dist="uniform", batch=_BATCH),
        Phase("drain", 32, "drain", batch=_BATCH),
        Phase("maintain", 16, "maintain", batch=_BATCH),
        Phase("refill", 12, "fill", batch=_BATCH),
    )


def _mixed_churn_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 16, "fill", batch=_BATCH),
        Phase("churn_up", 12, "churn", dist="zipf", batch=_BATCH),
        Phase("drain", 22, "drain", batch=_BATCH),
        Phase("cool", 12, "maintain", batch=_BATCH),
        Phase("refill", 10, "fill", batch=_BATCH),
        Phase("churn_down", 10, "churn", dist="zipf", batch=_BATCH),
    )


def _snapshot_restore_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 20, "fill", batch=_BATCH),
        # revive #1 at peak occupancy (stable traffic over the image)
        Phase("snapshot_restore", 8, "A", dist="uniform", batch=_BATCH),
        Phase("grow", 10, "fill", batch=_BATCH),
        # revive #2, then drain: post-revive auto-merges must fire
        Phase("snapshot_restore2", 26, "drain", batch=_BATCH),
        Phase("maintain", 10, "maintain", batch=_BATCH),
        Phase("refill", 8, "fill", batch=_BATCH),
    )


def _chaos_churn_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 18, "fill", batch=_BATCH),
        Phase("churn_up", 12, "churn", dist="zipf", batch=_BATCH),
        Phase("drain", 20, "drain", batch=_BATCH),
        Phase("cool", 10, "maintain", batch=_BATCH),
        Phase("refill", 10, "fill", batch=_BATCH),
        Phase("churn_down", 10, "churn", dist="uniform", batch=_BATCH),
    )


def _chaos_reshard_trace() -> Tuple[Phase, ...]:
    return (
        Phase("fill", 22, "fill", batch=_BATCH),
        Phase("stable", 12, "A", dist="uniform", batch=_BATCH),
        Phase("churn", 12, "churn", dist="zipf", batch=_BATCH),
        Phase("drain", 24, "drain", batch=_BATCH),
        Phase("maintain", 10, "maintain", batch=_BATCH),
        Phase("refill", 12, "fill", batch=_BATCH),
    )


_TRACES = {
    "uniform": _uniform_trace,
    "zipf": _zipf_trace,
    "phased_drain": _phased_drain_trace,
    "mixed_churn": _mixed_churn_trace,
    "snapshot_restore": _snapshot_restore_trace,
    "chaos_churn": _chaos_churn_trace,
    "chaos_reshard": _chaos_reshard_trace,
}

SCENARIOS = tuple(sorted(_TRACES))


def get_scenario(
    name: str,
    placement: str = "local",
    policy: bool = True,
    scale: float = 1.0,
    seed: int = 0,
) -> Tuple[TableSpec, Trace]:
    """Resolve a named scenario to ``(TableSpec, Trace)``."""
    if name not in _TRACES:
        raise KeyError(f"unknown scenario {name!r}; have {SCENARIOS}")
    phases = _scaled(_TRACES[name](), scale)
    trace = Trace(name=name, phases=phases, universe=_UNIVERSE, seed=seed)
    return _spec(placement, policy), trace


def scenario_matrix() -> Dict[str, Tuple[str, ...]]:
    """The acceptance matrix: scenario class x placement."""
    return {name: ("local", "sharded") for name in SCENARIOS}
