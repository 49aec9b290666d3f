"""YCSB-style workloads for the port: generators, phased traces, replay.

The JAX package's ``repro.workloads`` for local placement:

* :mod:`repro_torch.workloads.generators` and
  :mod:`repro_torch.workloads.trace` — copies of the JAX package's seeded
  generators and phased traces (the same seed gives the same op stream in
  both packages);
* :mod:`repro_torch.workloads.scenarios` — the named scenario registry on
  the port's ``TableSpec`` and ``ResizePolicy``;
* :mod:`repro_torch.workloads.replay` — runs a trace through the port's
  :class:`~repro_torch.table_api.Table` on one device and checks every
  status and read against the sequential oracle of
  :mod:`repro_torch.core.reference`.

The chaos harness and the serving driver are not ported yet.
"""

from repro_torch.workloads.generators import OpMix, YCSB_MIXES
from repro_torch.workloads.replay import ReplayMismatch, oracle_for, replay
from repro_torch.workloads.scenarios import SCENARIOS, get_scenario
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
]
