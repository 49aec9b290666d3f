#!/usr/bin/env python3
"""Run one ``wfbench`` cell with the program's own telemetry on.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s>
    python3 tools/trace_cell.py --workload <cell> --seed <n> \\
        --cost <pairs> --cost-seconds <s>

The first form runs the benchmark's ``--trace 1`` path as it is (its
profiled stretch, its host-timed stretch, its check, its lines) with each
stretch inside ``repro_torch.telemetry.collect()``, and prints a
``telemetry`` line before the result line: the program-side per-layer
metrics below, the summary per span name and the counters of the
host-timed stretch, the sync counts a hand count of the code expects, and
the device-idle microseconds of the profiled stretch by the innermost
program span the host was in (``idle_by_span``).

The second form measures what tracing costs: after the cell's set-up it
runs ``--cost`` pairs of windows of ``--cost-seconds``, one with
``collect()`` off and one with it on, in turns (off, on, on, off, ...),
and prints each window's ops/s.

The metrics (each ``None`` where its record is absent; per round over the
host-timed stretch unless said):

- ``host_syncs_per_round``: every ``sync.*`` count;
- ``sync_wait_ms_per_round``: total ms of the ``repro.sync.*`` spans;
- ``dispatch_self_ms_per_round``: self ms of ``repro.dispatch.*`` (the
  host's launches and bookkeeping around the kernels; the slow path and
  the syncs are child spans, left out);
- ``facade_self_ms_per_round``: self ms of ``repro.facade.*``;
- ``payload_host_ms_per_round``: total ms of ``repro.payload.*`` (their
  nested lookups included), on schema tables only;
- ``slowpath_lane_share``: ``slow.lanes`` over ``txn.live_lanes``, in %;
- ``idle_in_program_share``: in the profiled stretch, the device-idle
  time during which the host was inside a program span, over all
  device-idle time, in % (on a card only).

Exits non-zero without a card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import telemetry  # noqa: E402
from repro_torch.core import table as T  # noqa: E402
from wfbench import harness  # noqa: E402
from wfbench import trace as tr  # noqa: E402


# ---------------------------------------------------------------------------
# the metrics, from one record over ``rounds`` rounds


def _ms(rec, prefix, key):
    return sum(v[key] for k, v in rec.summary.items()
               if k.startswith(prefix)) / 1e6


def host_syncs_per_round(rec, rounds):
    if rec is None or not rounds:
        return None
    return sum(v for k, v in rec.counters.items()
               if k.startswith("sync.")) / rounds


def sync_wait_ms_per_round(rec, rounds):
    if rec is None or not rounds:
        return None
    return _ms(rec, "repro.sync.", "total_ns") / rounds


def dispatch_self_ms_per_round(rec, rounds):
    if rec is None or not rounds:
        return None
    return _ms(rec, "repro.dispatch.", "self_ns") / rounds


def facade_self_ms_per_round(rec, rounds):
    if rec is None or not rounds:
        return None
    return _ms(rec, "repro.facade.", "self_ns") / rounds


def payload_host_ms_per_round(rec, rounds):
    if rec is None or not rounds or not any(
            k.startswith("repro.payload.") for k in rec.summary):
        return None
    return _ms(rec, "repro.payload.", "total_ns") / rounds


def slowpath_lane_share(rec, rounds=None):
    if rec is None or not rec.counters.get("txn.live_lanes"):
        return None
    c = rec.counters
    return 100.0 * c.get("slow.lanes", 0) / c["txn.live_lanes"]


HOST_METRICS = (host_syncs_per_round, sync_wait_ms_per_round,
                dispatch_self_ms_per_round, facade_self_ms_per_round,
                payload_host_ms_per_round, slowpath_lane_share)


def hand_count(rec, n_lanes):
    """The ``sync.*`` counts the code implies, by site. A kernel
    transaction: one ``need_slow`` read, one ``applied`` write, and on a
    schema table four ``reconcile`` writes. On a card the slow path is one
    ``resize_apply`` launch and syncs nowhere. On CPU tensors it is the
    plain transaction: a call makes one ``fast_pass`` write past 256
    lanes, one ``pending`` read a round and one more where the call ends
    before its bound (22 rounds in every cell, far above what a call
    runs); a round of it one ``waves`` read, one ``wave_pass`` write, two
    ``split_pass`` and ten ``splits`` writes; and the plain kernels' wave
    loops add one ``waves`` read a transaction (not counted here)."""
    if rec is None:
        return None
    c = rec.counters
    txns = rec.summary.get("repro.facade.txn", {}).get("calls", 0)
    schema = "repro.payload.reconcile" in rec.summary
    rounds, calls = c.get("slow.rounds", 0), c.get("slow.calls", 0)
    if c.get("kernel.resize_apply.launches"):
        rounds = calls = 0
    want = {"sync.need_slow": txns, "sync.applied": txns,
            "sync.reconcile": 4 * txns if schema else 0,
            "sync.fast_pass": calls if n_lanes > T._PAIRWISE_MAX_LANES
            else 0,
            "sync.pending": rounds + calls, "sync.waves": rounds,
            "sync.wave_pass": rounds, "sync.split_pass": 2 * rounds,
            "sync.splits": 10 * rounds}
    return {k: v for k, v in want.items() if v}


# ---------------------------------------------------------------------------
# device idle time by program span


def innermost(spans):
    """``[(start, end, name)]`` of properly nested spans → disjoint sorted
    pieces ``(a, b, name)``, each labelled by the innermost span open in
    it."""
    out, stack, t = [], [], None
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            if t < end:
                out.append((t, end, inner))
                t = end
        if stack and t < a:
            out.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, inner = stack.pop()
        if t < end:
            out.append((t, end, inner))
            t = end
    return out


def idle_by_span(gaps, spans):
    """Idle time of the sorted disjoint ``gaps`` by the innermost of
    ``spans`` open in it (``{name: time}``); time outside every span is
    left out."""
    pieces = innermost(spans)
    out, i, j = {}, 0, 0
    while i < len(gaps) and j < len(pieces):
        a = max(gaps[i][0], pieces[j][0])
        b = min(gaps[i][1], pieces[j][1])
        if b > a:
            name = pieces[j][2]
            out[name] = out.get(name, 0) + (b - a)
        if gaps[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1
    return out


def profile_idle(prof, names):
    """``(idle_in_program_share, {span: idle µs}, idle µs)`` of a profiled
    stretch: the device's idle gaps over the benchmark's spans, as
    ``wfbench/trace.py::summarize`` finds them, put down to the innermost
    program span (a name in ``names``) the host was in."""
    events = list(prof.events())
    dev = [e for e in events if tr._is_device(e)]
    cpu = [e for e in events if not tr._is_device(e)
           and str(e.device_type).endswith("CPU")]
    marks = [e for e in cpu if e.name.startswith("wfbench.")]
    if not marks:
        return None, {}, 0.0
    lo = min(e.time_range.start for e in marks)
    hi = max(e.time_range.end for e in marks)
    busy = tr._union([[max(e.time_range.start, lo),
                       min(e.time_range.end, hi)]
                      for e in dev if e.time_range.end > lo
                      and e.time_range.start < hi])
    gaps, last = [], lo
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if hi > last:
        gaps.append((last, hi))
    idle = sum(b - a for a, b in gaps)
    threads = {}
    for e in marks:
        threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.thread == main and e.name in names]
    by = idle_by_span(gaps, spans)
    share = 100.0 * sum(by.values()) / idle if idle else None
    return share, by, idle


# ---------------------------------------------------------------------------
# the two forms


class _TracedRun(harness.Run):
    """``harness.Run`` with each window inside ``telemetry.collect()``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.windows = []     # (record, wall s, rounds) per window

    def window(self, seconds):
        with telemetry.collect() as rec:
            wall, n = super().window(seconds)
        self.windows.append((rec, wall, n))
        return wall, n


def _summary_ms(rec):
    return {k: {"calls": v["calls"], "total_ms": v["total_ns"] / 1e6,
                "self_ms": v["self_ns"] / 1e6}
            for k, v in sorted(rec.summary.items())}


def traced(workload, seed, seconds, device=None, root=ROOT):
    """The benchmark's traced run with telemetry on. Returns (result line,
    earlier lines, check lines, telemetry line)."""
    runs, profs = [], []
    summarize = tr.summarize

    def make_run(*a, **kw):
        runs.append(_TracedRun(*a, **kw))
        return runs[-1]

    def keep(prof, *a, **kw):
        profs.append(prof)
        return summarize(prof, *a, **kw)

    with mock.patch.object(harness, "Run", make_run), \
            mock.patch.object(tr, "summarize", keep):
        result, lines, checks = harness.run(root, workload, seed, seconds,
                                            True, time.perf_counter(),
                                            device=device)
    (rec_a, _, _), (rec_b, wall_b, n_b) = runs[0].windows
    metrics = {f.__name__: f(rec_b, n_b) for f in HOST_METRICS}
    line = {"rounds": n_b, "host_timed_s": wall_b,
            "summary": _summary_ms(rec_b), "counters": rec_b.counters,
            "hand_count": hand_count(rec_b,
                                     runs[0].config["spec"]["n_lanes"])}
    share, by, idle = (profile_idle(profs[0], set(rec_a.summary))
                       if profs else (None, {}, 0.0))
    metrics["idle_in_program_share"] = share
    line["metrics"] = {k: v for k, v in metrics.items() if v is not None}
    if profs:
        line["profiled"] = {
            "idle_us": idle, "counters": rec_a.counters,
            "idle_by_span": dict(sorted(by.items(), key=lambda kv: -kv[1]))}
    return result, lines, checks, {"telemetry": line}


def cost(workload, seed, pairs, seconds, device=None, root=ROOT):
    """ops/s of windows with ``collect()`` off and on, in turns."""
    files = harness.load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise harness.CellError("no CUDA device")
        device = torch.device("cuda", 0)
    r = harness.Run(files, seed, torch.device(device))
    r.setup()
    per_round = r.traffic.n_reads + r.traffic.n_writes
    out = {"off": [], "on": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                with telemetry.collect():
                    wall, n = r.window(seconds)
            else:
                wall, n = r.window(seconds)
            out["on" if on else "off"].append(n * per_round / wall)
    return {"cost": {"workload": workload, "seed": seed,
                     "seconds": seconds, "ops_per_s": out}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", type=int, default=0,
                   help="pairs of off/on windows (the second form)")
    p.add_argument("--cost-seconds", type=float, default=10.0)
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    torch.set_num_threads(1)        # as wfbench/run.py
    try:
        if a.cost:
            print(json.dumps(cost(a.workload, a.seed, a.cost,
                                  a.cost_seconds, a.device)), flush=True)
            return 0
        result, lines, checks, line = traced(a.workload, a.seed, a.seconds,
                                             a.device)
    except harness.CellError as e:
        print(f"trace_cell: {e}", file=sys.stderr)
        return 2
    for x in lines + [line]:
        print(json.dumps(x), flush=True)
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
