"""What a ``--trace 1`` run records, from the benchmark's own files.

Spans (``torch.profiler.record_function``) go around the calls into each
layer: ``wfbench.gen`` (the generator), ``wfbench.lookup`` and
``wfbench.write`` (the facade calls), ``wfbench.readback`` (the results to
the host); wrappers installed on the program's module attributes add
``repro.slowpath`` (``core/table.py::apply_batch``, the ``ST_FULL`` path)
and ``repro.payload`` (``table_api._alloc_handles`` / ``_write_payloads``
/ ``_reconcile_handles``). The wrappers are patched over the attributes
the program looks up at call time, as ``chip_smoke.py`` phases 6 and 8
do, for the traced window only.

Two clocks beside the profiler: ``SlowPathClock`` (host clock with a
synchronize on both sides of every ``apply_batch`` call) and
``StageClock`` (CUDA events around each payload stage, or the host clock
on a CPU run).
"""
from __future__ import annotations

import contextlib
import time

import torch

PAYLOAD_STAGES = ("_alloc_handles", "_write_payloads", "_reconcile_handles")


def span(name: str, on: bool):
    """A profiler span, or nothing when the run is not traced."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


class SlowPathClock:
    """Calls into ``apply_batch`` and their seconds, each bracketed by
    ``torch.cuda.synchronize()`` on a card (the host clock alone on the
    CPU). ``timing`` off leaves only a profiler span around the call."""

    def __init__(self, table_module, cuda: bool):
        self.fn, self.cuda = table_module.apply_batch, cuda
        self.calls, self.s, self.timing = 0, 0.0, False

    def __call__(self, *args, **kw):
        with torch.profiler.record_function("repro.slowpath"):
            if not self.timing:
                return self.fn(*args, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kw)
            if self.cuda:
                torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            self.calls += 1
            return out


class StageClock:
    """Device milliseconds of the payload side store's stages: a pair of
    CUDA events around each call, read once the window has closed (host
    milliseconds on the CPU)."""

    def __init__(self, api_module, cuda: bool):
        self.api, self.cuda = api_module, cuda
        self.pairs, self.host_ms, self.on = [], 0.0, False

    def wrap(self, name):
        fn = getattr(self.api, name)

        def timed(*args, **kw):
            with torch.profiler.record_function("repro.payload"):
                if not self.on:
                    return fn(*args, **kw)
                if self.cuda:
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    a.record()
                    out = fn(*args, **kw)
                    b.record()
                    self.pairs.append((a, b))
                    return out
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.host_ms += (time.perf_counter() - t0) * 1e3
                self.pairs.append(None)
                return out
        return timed

    def total_ms(self):
        """(calls, milliseconds) recorded while ``on``."""
        if self.cuda:
            torch.cuda.synchronize()
            return len(self.pairs), sum(a.elapsed_time(b)
                                        for a, b in self.pairs)
        return len(self.pairs), self.host_ms


# ---------------------------------------------------------------------------
# reading the profiler


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("wfbench.", "repro.")))


def _subtree_kernels(e):
    """(count, device microseconds) of the kernels linked to ``e`` and to
    every CPU event under it."""
    n, us, todo = 0, 0.0, [e]
    while todo:
        x = todo.pop()
        for k in x.kernels:
            n += 1
            us += k.duration
        todo.extend(x.cpu_children)
    return n, us


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, top: int = 10) -> dict:
    """Device busy time, kernels and device time inside the lookup and
    write spans, the busiest device operations and the idle gaps by what
    the host was doing, from one profiled stretch of rounds."""
    events = list(prof.events())
    dev = [e for e in events if _is_device(e)]
    cpu = [e for e in events if not _is_device(e)
           and str(e.device_type).endswith("CPU")]
    marks = sorted((e.time_range.start, e.time_range.end) for e in cpu
                   if e.name.startswith("wfbench."))
    if not marks:
        return {}
    lo, hi = marks[0][0], max(b for _, b in marks)
    busy = _union([[max(e.time_range.start, lo), min(e.time_range.end, hi)]
                   for e in dev if e.time_range.end > lo
                   and e.time_range.start < hi])
    busy_us = sum(b - a for a, b in busy)

    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    spans = {}
    for e in cpu:
        if e.name in ("wfbench.lookup", "wfbench.write"):
            n, us = _subtree_kernels(e)
            c, t = spans.get(e.name, (0, 0.0))
            spans[e.name] = (c + n, t + us)

    gaps = []
    last = lo
    for a, b in busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if hi > last:
        gaps.append((last, hi))
    idle = _name_gaps(cpu, gaps)
    return {
        "window_us": hi - lo, "busy_us": busy_us,
        "device_ops": [[n[:100], us / 1e6] for n, us in device_ops],
        "idle_gaps": sorted(([k, v / 1e6] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:top],
        "kernels": {k[len("wfbench."):]: v[0] for k, v in spans.items()},
        "span_device_us": {k[len("wfbench."):]: v[1]
                           for k, v in spans.items()},
    }


def _name_gaps(cpu, gaps) -> dict:
    """Idle microseconds by what the host was doing at each gap's middle:
    the outermost benchmark span and the innermost event open there."""
    if not gaps:
        return {}
    threads = {}
    for e in cpu:
        if e.name.startswith("wfbench."):
            threads[e.thread] = threads.get(e.thread, 0) + 1
    main = max(threads, key=threads.get)
    evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in cpu if e.thread == main), key=lambda x: x[0])
    out, stack, i = {}, [], 0
    for a, b in gaps:
        m = (a + b) / 2
        while i < len(evs) and evs[i][0] <= m:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        open_ = [s for s in stack if s[0] <= m <= s[1]]
        outer = next((s[2] for s in open_ if s[2].startswith("wfbench.")),
                     "host")
        inner = open_[-1][2] if open_ else "between rounds"
        name = outer if inner == outer else f"{outer} > {inner}"
        out[name] = out.get(name, 0.0) + (b - a)
    return out
