"""YCSB-style workloads for the port: generators, phased traces, replay.

The JAX package's ``repro.workloads``; the registry and replay serve
both placements, ``serve_closed_loop`` and the chaos harness local
placement only:

* :mod:`repro_torch.workloads.generators` and
  :mod:`repro_torch.workloads.trace` — copies of the JAX package's seeded
  generators and phased traces (the same seed gives the same op stream in
  both packages);
* :mod:`repro_torch.workloads.scenarios` — the named scenario registry on
  the port's ``TableSpec`` and ``ResizePolicy``;
* :mod:`repro_torch.workloads.replay` — runs a trace through the port's
  :class:`~repro_torch.table_api.Table` on one device and checks every
  status and read against the sequential oracle of
  :mod:`repro_torch.core.reference`;
* :mod:`repro_torch.workloads.serving_driver` — the closed-loop
  multi-client driver of the serving router
  (:mod:`repro_torch.serving.router`), checked in the router's
  linearization order, with an optional mid-trace handover;
* :mod:`repro_torch.workloads.chaos` — the chaos replay harness: a
  seed-deterministic fault-injection schedule (kill/revive, re-shard,
  policy flaps, backend swaps, router handovers, torn saves) over any
  registry scenario, checked per op and per event against the streaming
  oracle, with a failing-seed CLI
  (``python -m repro_torch.workloads.chaos --seed N``).
"""

from repro_torch.workloads.generators import OpMix, YCSB_MIXES
from repro_torch.workloads.replay import ReplayMismatch, oracle_for, replay
from repro_torch.workloads.scenarios import SCENARIOS, get_scenario
from repro_torch.workloads.serving_driver import serve_closed_loop
from repro_torch.workloads.trace import Phase, Trace

__all__ = [
    "OpMix",
    "YCSB_MIXES",
    "Phase",
    "Trace",
    "replay",
    "oracle_for",
    "ReplayMismatch",
    "SCENARIOS",
    "get_scenario",
    "serve_closed_loop",
    "EVENT_KINDS",
    "ChaosConfig",
    "ChaosEvent",
    "gen_schedule",
    "chaos_setup",
    "chaos_replay",
    "shrink_schedule",
]

# chaos is exported lazily (PEP 562): an eager import would make
# ``python -m repro_torch.workloads.chaos`` import the module twice
_CHAOS_NAMES = frozenset(__all__[__all__.index("EVENT_KINDS"):])


def __getattr__(name):
    if name in _CHAOS_NAMES:
        from repro_torch.workloads import chaos

        return getattr(chaos, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
