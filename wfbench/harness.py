"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is comes from files found by name: ``BENCHMARK.json``
names the cell's configuration and traffic; the configuration's ``file``
holds the table's spec and key space, ``<paths[0]>/traffic/<traffic>.json``
the traffic's parameters, ``<paths[0]>/metrics/<metric>.py`` each
per-layer metric's reader. Adding a cell is adding files.

The system under test is ``repro_torch.table_api.Table`` (imported from the
checkout's ``src/``): built with ``Table.create``, loaded through its own
insert path, then driven by the window's rounds. A round is one
``Table.lookup`` of the round's reads, one write call (``Table.apply`` or
``Table.update``), and the results the caller waits for: the found flags
and statuses on the host (with the raw values, or a seeded sample of the
payload records). Its time runs from the first call's submission until
those are on the host; the window runs rounds back to back, the
generator's work between them included, until ``--seconds`` have passed.

Set-up loads the configuration's keys through the table's insert path.
A YCSB key space (``records``) then updates every record once, untimed:
an update that meets a bucket the load left full takes the slow path and
splits it, so without this pass the window would open on that transient
and its length would set what it measures.

After the window the memory peak is read, the table's final content is
read through the facade (its size, every key the run touched, a seeded
sample of the values or records) and the table freed; then the plain
reference (``reference/``) replays every round from the same seed and
every answer is compared.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from wfbench import gen, peaks
from wfbench import trace as tr
from wfbench.reference import KVReference, record_bytes

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
WARM_ROUNDS = 2
# profiled part of a --trace 1 window (at most), then host-timed rounds
TRACE_SECONDS = 3.0
FINAL_SAMPLE = 4096
# keys a call of the load, the settling update and the final read
CHUNK = 16384
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(Exception):
    """The cell cannot run here (no card, too few cards, a bad file)."""


# ---------------------------------------------------------------------------
# finding a cell's files


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files, by name, from ``root``'s
    ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    base = root / bench["paths"][0]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return {"cell": cell, "config": config, "traffic": traffic,
            "base": base,
            "end_to_end": metrics_for(bench["end_to_end"], workload),
            "per_layer": metrics_for(bench["per_layer"], workload)}


def metrics_for(entries, workload):
    return [m for m in entries if workload in m.get("workloads", [workload])]


def load_reader(base: Path, name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "wfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def import_program():
    """``repro_torch``'s facade from the checkout's ``src/``."""
    src = str(CHECKOUT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import table_api
    return table_api


def schema_fields(config):
    """``[(name, shape)]`` of a schema configuration (uint8 fields only:
    payloads are bytes), or None in raw mode."""
    schema = config.get("schema")
    if schema is None:
        return None
    fields = []
    for name, (dtype, shape) in schema.items():
        if dtype != "uint8":
            raise CellError(f"field {name}: payload fields are uint8")
        fields.append((name, tuple(shape)))
    return fields


def make_table(config, device, fields=None):
    """The program's table for ``config`` on ``device``."""
    api = import_program()
    kw = dict(config["spec"])
    kw["backend"] = "cuda"
    if config.get("schema"):
        kw["value_schema"] = {n: (d, tuple(s))
                              for n, (d, s) in config["schema"].items()}
    return api.Table.create(api.TableSpec(**kw), device=device)


# ---------------------------------------------------------------------------
# one run


class Run:
    """State of one run: the table, the traffic and what came back."""

    def __init__(self, files, seed, device, table_factory=None):
        self.seed, self.device = int(seed), device
        self.config = files["config"]
        self.fields = schema_fields(self.config)
        self.record = (sum(int(np.prod(s)) for _, s in self.fields)
                       if self.fields else 0)
        self.traffic = gen.Traffic(self.config, files["traffic"], seed,
                                   device)
        self.cuda = device.type == "cuda"
        self.factory = table_factory or make_table
        self.host = []        # per round: the bytes read back
        self.round_s = []     # per window round: seconds
        self.tracing = False

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    # -- set-up ------------------------------------------------------------

    def values_of(self, keys, versions, raw):
        if self.fields is None:
            return raw
        rows = gen.payload_bytes(self.seed, keys, versions, self.record)
        return gen.split_fields(rows, self.fields)

    def setup(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.table = self.factory(self.config, self.device, self.fields)
        tf = self.traffic
        idx = tf.preload_idx()
        bad = []
        for a in range(0, idx.numel(), CHUNK):
            i = idx[a:a + CHUNK]
            keys = tf.key_of(i)
            vals = self.values_of(keys, torch.zeros_like(i),
                                  tf.preload_values(i))
            self.table, res = self.table.insert(keys, vals)
            bad.append((res.status != 1).sum())
        if tf.records is not None:
            for a in range(0, idx.numel(), CHUNK):
                i = idx[a:a + CHUNK]
                keys = tf.key_of(i)
                v = tf.settle_versions(i)
                vals = self.values_of(keys, v, v.to(torch.int32))
                self.table, res = self.table.update(keys, vals)
                bad.append((res.status != 0).sum())
        self.preload_bad = int(torch.stack(bad).sum())
        self.rnd = 0
        for _ in range(WARM_ROUNDS):
            self.step(timed=False)
        self.sync()

    # -- rounds ------------------------------------------------------------

    def step(self, timed=True):
        """One round: generate, call, read back; a timed round's seconds
        join ``round_s``."""
        on = self.tracing
        with tr.span("wfbench.gen", on):
            ops = self.traffic.round(self.rnd)
            values = self.values_of(ops.keys, ops.versions, ops.values)
        t0 = time.perf_counter()
        with tr.span("wfbench.lookup", on):
            found, got = self.table.lookup(ops.reads)
        with tr.span("wfbench.write", on):
            if self.traffic.call == "update":
                self.table, res = self.table.update(ops.keys, values)
            else:
                self.table, res = self.table.apply(ops.kinds, ops.keys,
                                                   values)
        with tr.span("wfbench.readback", on):
            if self.fields is None:
                back = got.view(torch.uint8)
            else:
                back = torch.cat([got[n].reshape(got[n].shape[0], -1)
                                  [ops.sample] for n, _ in self.fields],
                                 dim=1).reshape(-1)
            host = torch.cat([found.view(torch.uint8), back,
                              res.status.view(torch.uint8)]).cpu().numpy()
        s = time.perf_counter() - t0
        self.host.append(host)
        self.last_error = res.error
        self.rnd += 1
        if timed:
            self.round_s.append(s)

    def window(self, seconds):
        """Rounds back to back until ``seconds`` have passed (two rounds at
        the least); returns the window's wall seconds and its rounds."""
        first = self.rnd
        t0 = time.perf_counter()
        while True:
            self.step()
            t1 = time.perf_counter()
            if t1 - t0 >= seconds and self.rnd - first >= 2:
                return t1 - t0, self.rnd - first

    # -- after the window --------------------------------------------------

    def final_content(self):
        """The table's final content read through the facade: its size,
        the found flag of every key-space index the run touched, and the
        raw values or the records of a seeded sample of the found ones,
        on the host."""
        t, tf = self.table, self.traffic
        n = tf.universe if tf.universe is not None else tf.window(self.rnd)[1]
        found, vals = [], []
        for a in range(0, n, CHUNK):
            idx = torch.arange(a, min(a + CHUNK, n), device=self.device)
            f, v = t.lookup(tf.key_of(idx))
            found.append(f.cpu())
            if self.fields is None:
                vals.append(v.cpu())
        found = torch.cat(found).numpy()
        content = {"size": int(t.size()), "found": found}
        if self.fields is None:
            content["values"] = torch.cat(vals).numpy().astype(np.int64)
            return content
        live = np.nonzero(found)[0]
        pick = live[self._final_pick(live.size)]
        _, got = t.lookup(tf.key_of(torch.tensor(pick, device=self.device)))
        content["pick"] = pick
        content["rows"] = torch.cat(
            [got[name].reshape(pick.size, int(np.prod(shape)))
             for name, shape in self.fields],
            dim=1).cpu().numpy()
        return content

    def _final_pick(self, n):
        k = min(FINAL_SAMPLE, n)
        g = np.random.default_rng([self.seed & 0xFFFFFFFF,
                                   (self.seed >> 32) & 0xFFFFFFFF, n])
        return np.sort(g.choice(n, size=k, replace=False))

    def check(self, n_window_rounds, content):
        """Replay every round on the reference; count mismatches."""
        tf = self.traffic
        ref = KVReference()
        pre = tf.preload_idx()
        pre_np = pre.cpu().numpy()
        ref.load(pre_np, (tf.preload_values(pre).cpu().numpy()
                          if self.fields is None else 0))
        if tf.records is not None:
            ref.update(pre_np, tf.settle_versions(pre).cpu().numpy())
        n_r, n_w = tf.n_reads, tf.n_writes
        k = tf.sample_reads
        bad = dict(status=0, found=0, value=0)
        failed = 0
        first_window = len(self.host) - n_window_rounds
        for r, host in enumerate(self.host):
            ops = tf.round(r)
            read_idx = ops.read_idx.cpu().numpy()
            found = host[:n_r].astype(bool)
            status = host[-n_w:].view(np.int8)
            f_ref, v_ref = ref.lookup(read_idx)
            wrong_f = found != f_ref
            if self.fields is None:
                got = host[n_r:n_r + 4 * n_r].view(np.int32)
                wrong_v = ~wrong_f & (got != v_ref)
            else:
                s = ops.sample.cpu().numpy()
                got = host[n_r:-n_w].reshape(k, self.record)
                want = record_bytes(self.seed, ops.reads.cpu().numpy()[s],
                                    v_ref[s], self.record)
                want[~f_ref[s]] = 0
                wrong_v = np.zeros(n_r, bool)
                wrong_v[s[(got != want).any(axis=1)]] = True
                wrong_v &= ~wrong_f
            widx = ops.write_idx.cpu().numpy()
            if tf.call == "update":
                s_ref = ref.update(widx, ops.versions.cpu().numpy())
            else:
                vals = (ops.values.cpu().numpy().astype(np.int64)
                        if self.fields is None else
                        ops.versions.cpu().numpy())
                s_ref = ref.apply(ops.kinds.cpu().numpy(), widx, vals)
            wrong_s = status != s_ref
            bad["found"] += int(wrong_f.sum())
            bad["value"] += int(wrong_v.sum())
            bad["status"] += int(wrong_s.sum())
            if r >= first_window:
                failed += int(wrong_f.sum() + wrong_v.sum() + wrong_s.sum())
        bad["content"] = self._content_mismatches(ref, content)
        return bad, failed

    def _content_mismatches(self, ref, content):
        found = content["found"]
        f_ref, v_ref = ref.lookup(np.arange(found.size))
        bad = int((found != f_ref).sum())
        bad += int(content["size"] != ref.live().size)
        if self.fields is None:
            return bad + int((f_ref & (content["values"] != v_ref)).sum())
        pick = content["pick"]
        keys = self.traffic.key_of(torch.tensor(pick)).numpy()
        rows = record_bytes(self.seed, keys, v_ref[pick], self.record)
        return bad + int((content["rows"] != rows).any(axis=1).sum())


# ---------------------------------------------------------------------------
# the whole run


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, table_factory=None):
    """Run one cell; returns (result line, earlier stdout lines, check
    lines for stderr)."""
    files = load_cell(root, workload)
    chips = int(files["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise CellError("no CUDA device")
        if torch.cuda.device_count() < chips:
            raise CellError(f"{chips} cards asked, "
                            f"{torch.cuda.device_count()} here")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    r = Run(files, seed, device, table_factory)
    r.setup()
    setup_s = time.perf_counter() - t_start
    api = import_program() if table_factory is None else None
    launches0 = _launches(api)

    lines = []
    if trace:
        metrics, extra, breakdown, dev_extra = _traced_window(
            r, files, seconds, api)
        lines.append(extra)
    else:
        wall, n = r.window(seconds)
        ops = n * (r.traffic.n_reads + r.traffic.n_writes)
        dev_extra = {}
    peak = torch.cuda.max_memory_allocated(device) if r.cuda else 0
    size = int(r.table.size())
    error = bool(r.last_error)
    n_window = len(r.round_s)
    launches = _launches(api)
    if launches:
        lines.append({"launches_per_round": {
            k: (launches[k] - launches0[k]) / max(n_window, 1)
            for k in launches}, "rounds": n_window})
    content = r.final_content()
    del r.table
    if r.cuda:
        torch.cuda.empty_cache()
    bad, failed = r.check(n_window, content)
    checks = {
        "status_mismatches": (bad["status"], 0),
        "found_mismatches": (bad["found"], 0),
        ("value_mismatches" if r.fields is None else "payload_mismatches"):
            (bad["value"], 0),
        "content_mismatches": (bad["content"], 0),
        "preload_mismatches": (r.preload_bad, 0),
        "error_flag": (int(error), 0),
    }
    correct = all(v <= lim for v, lim in checks.values())
    if not trace:
        values = {
            "ops_per_s": ops / wall,
            "round_p95_ms": statistics.quantiles(
                r.round_s, n=20, method="inclusive")[-1] * 1e3,
            "bytes_per_item": peak / max(size, 1),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in files["end_to_end"] if m["name"] in values}
    dev = {"platform": "gpu" if r.cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if r.cuda else "cpu",
           "count": chips if r.cuda else 0, "memory_peak_bytes": peak}
    dev.update(dev_extra)
    result = {"correct": correct,
              "attempted": n_window * (r.traffic.n_reads
                                       + r.traffic.n_writes),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and breakdown:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    check_lines = [f"check {k} {v} limit {lim}"
                   for k, (v, lim) in checks.items()]
    return result, lines, check_lines


def _launches(api):
    if api is None:
        return {}
    from repro_torch.kernels import apply as ka
    from repro_torch.kernels import lookup as kl
    return {f.__name__: f.launches for f in (kl.fused_probe, kl.probe,
                                             ka.fused_apply,
                                             ka.grouped_apply)}


def _traced_window(r: Run, files, seconds, api):
    """The ``--trace 1`` window: a profiled stretch (at most
    ``TRACE_SECONDS``, with spans and no synchronizing clocks), then the
    rest with the slow path's host clock and the payload stages' events."""
    from repro_torch.core import table as T
    slow = tr.SlowPathClock(T, r.cuda)
    stages = tr.StageClock(api, r.cuda)
    part_a = min(TRACE_SECONDS, seconds / 2)
    prof = None
    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(T, "apply_batch", slow))
        for name in tr.PAYLOAD_STAGES:
            patches.enter_context(mock.patch.object(api, name,
                                                    stages.wrap(name)))
        r.tracing = True
        if r.cuda:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        first_a = r.rnd
        wall_a, n_a = r.window(part_a)
        if prof is not None:
            r.sync()
            prof.stop()
        r.tracing = False
        slow.timing, stages.on = True, True
        first_b = r.rnd
        wall_b, n_b = r.window(seconds - part_a)
        r.sync()
        slow.timing = False
        n_stage, stage_ms = stages.total_ms()

    summary = tr.summarize(prof) if prof is not None else {}
    ctx = {"rounds_a": n_a, "wall_a_s": wall_a, "rounds_b": n_b,
           "wall_b_s": wall_b, "round_s_b": r.round_s[-n_b:],
           "slow_s_b": slow.s,
           "slow_calls_b": slow.calls,
           "txns_b": n_b * _txns(r), "stage_calls_b": n_stage,
           "payload_ms_b": stage_ms, "profile": summary,
           "lookup_bytes_a": None, "apply_bytes_a": None}
    if summary:
        ctx["lookup_bytes_a"], ctx["apply_bytes_a"] = _bytes(
            r, range(first_a, first_a + n_a))
    metrics = {}
    for m in files["per_layer"]:
        v = load_reader(files["base"], m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_extra = {}
    breakdown = None
    if summary:
        dev_extra.update(busy_s=summary["busy_us"] / 1e6,
                         window_s=summary["window_us"] / 1e6)
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    extra = {"trace": {"rounds_profiled": n_a, "profiled_s": wall_a,
                       "rounds_host_timed": n_b, "host_timed_s": wall_b,
                       "first_host_timed_round": first_b,
                       "slowpath_calls": slow.calls,
                       "kernels_in_spans": summary.get("kernels"),
                       "span_device_us": summary.get("span_device_us")}}
    return metrics, extra, breakdown, dev_extra


def _txns(r: Run) -> int:
    """Write transactions per round: one per ``n_lanes`` chunk."""
    n = int(r.config["spec"]["n_lanes"])
    return -(-r.traffic.n_writes // n)


def _bytes(r: Run, rounds):
    """Bytes the profiled rounds' lookups and write calls need."""
    tf, B = r.traffic, int(r.config["spec"].get("bucket_size", 8))
    look = app = 0.0
    for rnd in rounds:
        host = r.host[rnd]
        ops = tf.round(rnd)
        hits = int(host[:tf.n_reads].astype(bool).sum())
        look += peaks.lookup_bytes(tf.n_reads, hits, B, r.record)
        app += peaks.apply_bytes(ops.kinds.cpu().numpy(),
                                 ops.keys.cpu().numpy(),
                                 host[-tf.n_writes:].view(np.int8), B,
                                 r.record)
    return look, app


def forbidden_modules():
    """Top-level names of JAX or the JAX package loaded in this process,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
