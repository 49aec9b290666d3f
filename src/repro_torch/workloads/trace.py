"""Phased traces: named sequences of (mix, distribution, steps) phases.

A copy of the JAX package's ``repro/workloads/trace.py``.

A :class:`Trace` is the declarative description of a whole workload run —
e.g. fill -> stable -> drain -> refill — and :func:`gen_steps` materializes
it into the deterministic step stream both the table under test and the
sequential reference oracle consume. Phases shift the operation mix and
the key-skew mid-run, which is exactly the regime where a watermark resize
policy must react (grow on fill, shrink on drain, stay put on stable).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple, Union

from repro_torch.workloads.generators import YCSB_MIXES, OpMix, Step, StepGen


@dataclasses.dataclass(frozen=True)
class Phase:
    """One homogeneous stretch of a trace.

    ``mix`` is an :class:`OpMix` or the name of one in ``YCSB_MIXES``;
    ``dist`` ∈ {uniform, zipf, latest} with ``theta`` skew; ``batch`` op
    slots are drawn per step."""

    name: str
    steps: int
    mix: Union[str, OpMix]
    dist: str = "uniform"
    theta: float = 0.99
    batch: int = 64

    def op_mix(self) -> OpMix:
        return YCSB_MIXES[self.mix] if isinstance(self.mix, str) else self.mix


@dataclasses.dataclass(frozen=True)
class Trace:
    """A named, seeded phase sequence over a key universe."""

    name: str
    phases: Tuple[Phase, ...]
    universe: int = 1 << 16
    seed: int = 0

    @property
    def total_steps(self) -> int:
        return sum(p.steps for p in self.phases)


def gen_steps(trace: Trace) -> Iterator[Step]:
    """Materialize the trace into its deterministic step stream."""
    gen = StepGen(trace.universe, trace.seed)
    for phase in trace.phases:
        mix = phase.op_mix()
        for _ in range(phase.steps):
            yield gen.step(
                phase.name,
                mix,
                phase.batch,
                dist=phase.dist,
                theta=phase.theta,
            )


def phased(
    name: str,
    universe: int = 1 << 16,
    seed: int = 0,
    fill_steps: int = 30,
    stable_steps: int = 20,
    drain_steps: int = 30,
    refill_steps: int = 15,
    batch: int = 48,
    dist: str = "uniform",
    theta: float = 0.99,
) -> Trace:
    """The canonical fill -> stable -> drain -> maintain -> refill trace.

    Fill grows the directory (auto-splits), drain plus the read-mostly
    maintain phase shrinks it back (auto-merges), refill grows it again —
    a full elastic round trip in one trace."""
    return Trace(
        name=name,
        universe=universe,
        seed=seed,
        phases=(
            Phase("fill", fill_steps, "fill", dist="uniform", batch=batch),
            Phase("stable", stable_steps, "A", dist=dist, theta=theta, batch=batch),
            Phase("drain", drain_steps, "drain", dist="uniform", batch=batch),
            Phase("maintain", max(4, drain_steps // 2), "maintain", batch=batch),
            Phase("refill", refill_steps, "fill", batch=batch),
        ),
    )
