"""Spans and counters on the table path, recorded only inside ``collect()``.

The table path (``table_api.py``, ``kernels/ops.py``, ``core/table.py``)
calls :func:`span`, :func:`count`, :func:`count_device` and
:func:`host_read` where its work happens. Outside :func:`collect` each is
one test of a module flag: ``span`` returns one shared no-op context
manager, the counters return at once and ``host_read`` is ``x.item()``.
Nothing reads a clock, allocates, enters the profiler or touches the
device.

Inside ``collect()`` (one at a time in a process; spans from any thread):

- ``span(name)`` records its name, its start and end on
  ``time.perf_counter_ns``, its parent span (a stack per thread) and a
  call id that every span under one outermost span shares (one facade
  call). While a ``torch.profiler`` is recording it also enters
  ``torch.profiler.record_function(name)``, so the range sits in the
  device trace on the profiler's own clock.
- ``count(name, n)`` adds to a host counter; ``count_device(name, t)``
  adds ``t`` into a device accumulator of its shape without a sync (one
  elementwise kernel), summed and read once when the record closes.
- ``host_read(site, x)`` is the table path's one way to read a device
  value on the host: ``x.item()``, counted as ``sync.<site>`` and timed
  as the span ``repro.sync.<site>``. ``host_write(site, x, index, value)``
  is its one way to write a Python scalar into a tensor, ``x[index] =
  value``: on a CUDA tensor torch copies the scalar from the host and
  waits for the stream, a host sync as much as a read, counted and timed
  the same way.

Program spans are named ``repro.<layer>.<what>``: ``facade``, ``payload``,
``dispatch``, ``core`` and ``sync``. When ``collect()`` closes, its
:class:`Record` holds the spans, the counters (the five kernel wrappers'
``.launches`` deltas among them, as ``kernel.<name>.launches``) and a
summary per span name: calls, total and self nanoseconds (self: the
duration less the durations of its child spans).

    from repro_torch import telemetry
    with telemetry.collect() as rec:
        table, res = table.update(keys, values)
    rec.summary["repro.facade.txn"], rec.counters["sync.need_slow"]
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

# the one module-level switch: set and cleared by collect() alone, so the
# call sites need not carry a handle to the record
_ON = False
_record = None
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int   # index into Record.spans, -1 for an outermost span
    call: int     # shared by every span under one outermost span
    thread: int


class Record:
    """What one ``collect()`` saw: ``spans`` (in the order they opened),
    ``counters`` and ``summary`` (filled when it closes)."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.summary = {}
        self._device = {}
        self._calls = itertools.count()
        self._lock = threading.Lock()

    def _add(self, name, n):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _close(self, launches_before, launches_after):
        end = time.perf_counter_ns()
        for (name, _, _), acc in self._device.items():
            if isinstance(name, tuple):
                for one, n in zip(name, acc.tolist()):
                    self._add(one, n)
            else:
                self._add(name, int(acc.sum().item()))
        self._device = {}
        for name, n in launches_after.items():
            self._add(f"kernel.{name}.launches", n - launches_before[name])
        index = {id(e): i for i, e in enumerate(self.spans)}
        spans = [Span(name, t0, t1 or end,
                      -1 if parent is None else index[id(parent)], call,
                      thread)
                 for name, t0, t1, parent, call, thread in self.spans]
        child_ns = [0] * len(spans)
        for s in spans:
            if s.parent >= 0:
                child_ns[s.parent] += s.end_ns - s.start_ns
        summary = {}
        for s, inner in zip(spans, child_ns):
            entry = summary.setdefault(s.name, {"calls": 0, "total_ns": 0,
                                                "self_ns": 0})
            entry["calls"] += 1
            entry["total_ns"] += s.end_ns - s.start_ns
            entry["self_ns"] += s.end_ns - s.start_ns - inner
        self.spans, self.summary = spans, summary


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "rec", "entry", "range")

    def __init__(self, name, rec):
        self.name, self.rec, self.range = name, rec, None

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        call = parent[4] if parent is not None else next(self.rec._calls)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.entry = [self.name, time.perf_counter_ns(), 0, parent, call,
                      threading.get_ident()]
        self.rec.spans.append(self.entry)
        stack.append(self.entry)
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns()
        _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stretch of the table path's work: the
    shared no-op outside ``collect()``."""
    if not _ON:
        return _NOOP
    return _Span(name, _record)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (inside ``collect()``)."""
    if _ON:
        _record._add(name, n)


def count_device(name, t: torch.Tensor) -> None:
    """Add the sum of the device tensor ``t`` (a mask, say) to the counter
    ``name`` without a sync (inside ``collect()``): ``t`` is added into an
    int64 accumulator of its shape, which is summed when the record
    closes. With a tuple of names, ``t`` is 1-d and each element goes to
    its own counter."""
    if not _ON:
        return
    rec = _record
    key = (name, tuple(t.shape), t.device)
    with rec._lock:
        acc = rec._device.get(key)
        if acc is None:
            rec._device[key] = t.to(torch.int64, copy=True)
        else:
            acc.add_(t)


def _sync(site):
    rec = _record
    rec._add("sync." + site, 1)
    return _Span("repro.sync." + site, rec)


def host_read(site: str, x: torch.Tensor):
    """``x.item()``: the table path's device-to-host reads all come here.
    Inside ``collect()`` it counts ``sync.<site>`` and times the read as
    the span ``repro.sync.<site>``."""
    if not _ON:
        return x.item()
    with _sync(site):
        return x.item()


def host_write(site: str, x: torch.Tensor, index, value) -> None:
    """``x[index] = value`` for a Python scalar ``value``: the table path's
    scalar writes all come here, since on a CUDA tensor each one copies the
    scalar from the host and waits for the stream. Inside ``collect()`` it
    counts ``sync.<site>`` and times the write as the span
    ``repro.sync.<site>``."""
    if not _ON:
        x[index] = value
        return
    with _sync(site):
        x[index] = value


def _launches() -> dict:
    from repro_torch.kernels import apply, lookup, resize
    out = {f.__name__: f.launches for f in (lookup.fused_probe, lookup.probe,
                                            apply.fused_apply,
                                            apply.grouped_apply)}
    out["resize_apply"] = resize.launches
    return out


@contextlib.contextmanager
def collect():
    """Record the table path's spans and counters until the block ends;
    yields the :class:`Record`, complete once the block has closed."""
    global _ON, _record
    if _ON:
        raise RuntimeError("telemetry.collect() is already recording")
    rec = Record()
    before = _launches()
    _record, _ON = rec, True
    try:
        yield rec
    finally:
        _ON, _record = False, None
        rec._close(before, _launches())
