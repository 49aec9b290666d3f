#!/usr/bin/env python3
"""Time the two lookup kernels at every block size on one GPU.

    python3 tools/probe_timing.py [--baseline CSRC_DIR] [--seed N]

Builds ``fused_probe.cu`` and ``probe.cu`` of this checkout once (their
block size is a launch argument, ``kernels/tuning.py::BLOCKS``: 32, 64,
128 and 256) and, with ``--baseline``, also the two sources of another
``csrc`` directory (the parent commit unpacked with ``git archive``, say)
into ``build/probe_timing/``. A baseline whose launchers take no block
size (its own is a compile-time constant) is called without one; one that
takes it is called at the default block. On the main path's table after
its preload (dmax 20, 2**20 rows of 8 slots, 2**19 keys inserted through
the facade) it checks every (build, block) against the plain versions,
then times each warm (back to back) and cold (the L2 flushed before each
launch) with ``chip_smoke.py``'s harnesses: ``fused_probe`` on the main
path's 4,608-query lookups, ``probe`` on the wide path's 36,864 pre-routed
queries, half of them live keys. Every (build, block) is timed twice, in
one order and then in the reverse order. Last, at the default block size,
the vector row path against the slot-by-slot path (the same pools at a
storage offset of one element) on tables of 4, 8, 16 and 32 slots a row (a
depth-17 directory over the first 2**17 rows, half-full rows), twice in
turns. One JSON line per reading, the card's ``nvidia-smi`` name and power
limit first; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SOURCES = {"fused_probe": "fused_probe.cu", "probe": "probe.cu"}
OUT = ROOT / "build" / "probe_timing"
# a launcher that takes the block size (this checkout's ABI)
BLOCK_ARG_RE = re.compile(r"probe_launch\([^)]*int threads", re.S)


class Build:
    """One build's two entry points; ``blocks`` are the block sizes it
    takes (``(None,)`` for a launcher without a block argument)."""

    def __init__(self, lib_paths: dict[str, Path], block_arg: bool):
        from repro_torch.kernels.lookup import (_FUSED_ARGTYPES,
                                                _PROBE_ARGTYPES)
        from repro_torch.kernels.tuning import BLOCKS
        self.block_arg = block_arg
        fused = _FUSED_ARGTYPES if block_arg else (
            _FUSED_ARGTYPES[:-2] + _FUSED_ARGTYPES[-1:])
        probe = _PROBE_ARGTYPES if block_arg else (
            _PROBE_ARGTYPES[:-2] + _PROBE_ARGTYPES[-1:])
        self.fused = ctypes.CDLL(str(lib_paths["fused_probe"])
                                 ).fused_probe_launch
        self.fused.argtypes, self.fused.restype = fused, ctypes.c_int
        self.probe = ctypes.CDLL(str(lib_paths["probe"])).probe_launch
        self.probe.argtypes, self.probe.restype = probe, ctypes.c_int
        self.blocks = BLOCKS if block_arg else (None,)


def build(baseline: Path | None) -> dict[str, Build]:
    """This checkout's kernels (``kernels/_build.py``) and the baseline's,
    one nvcc per baseline source, all started together."""
    from repro_torch.kernels import _build
    _build.build_all()
    builds = {"this": Build({k: _build.build_dir() / f"{Path(src).stem}.so"
                             for k, src in SOURCES.items()}, True)}
    if baseline is None:
        return builds
    nvcc = _build._nvcc()
    jobs, libs = [], {}
    for kernel, src in SOURCES.items():
        lib = OUT / "lib" / "baseline" / f"{kernel}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(baseline), "-o", str(lib),
               str(baseline / src)]
        jobs.append((lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        libs[kernel] = lib
    for lib, proc in jobs:
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {lib}:\n{log}")
    builds["baseline"] = Build(libs, bool(BLOCK_ARG_RE.search(
        (baseline / "probe.cu").read_text())))
    return builds


def main_table(rng, dev):
    """The main path's table after its preload (``chip_smoke.py``'s spec,
    2**19 keys through the facade): (directory, keys, values, live keys)
    as the lookup kernels see them."""
    from repro_torch.table_api import Table, TableSpec
    t = Table.create(TableSpec(**cs.MAIN_SPEC, backend="cuda"), device=dev)
    keys = cs.distinct_keys(rng, cs.PRELOAD)
    vals = rng.integers(0, 2**31 - 1, size=keys.size).astype(np.int32)
    t, _ = t.insert(torch.tensor(keys, device=dev),
                    torch.tensor(vals, device=dev))
    st = t.state
    return st.directory, st.keys[:-1], st.vals[:-1], keys


def pools(rng, B, dev, P=1 << 20, depth=17):
    """A directory at ``depth`` over the first 2**depth rows, shuffled (the
    table hands out rows from the front), and [P, B] pools with B // 2 keys
    on each live row: (directory, keys, values, live keys)."""
    dmax = cs.MAIN_SPEC["dmax"]
    rows = rng.permutation(1 << depth).astype(np.int32)
    directory = rows[np.arange(1 << dmax) >> (dmax - depth)]
    pk = np.full((P, B), cs.EMPTY, np.int32)
    pv = np.zeros((P, B), np.int32)
    keys = cs.distinct_keys(rng, (B // 2) << depth)
    placed = cs.place_keys(pk, pv, keys, cs.route_np(keys, directory, dmax),
                           B, rng)
    return (torch.tensor(directory, device=dev), torch.tensor(pk, device=dev),
            torch.tensor(pv, device=dev), keys[placed])


class Inputs:
    """64 query sets per kernel, bucket ids routed beforehand for ``probe``,
    and output buffers, on one pair of pools."""

    def __init__(self, rng, directory, pk, pv, live, dev):
        dmax = cs.MAIN_SPEC["dmax"]
        d_np = directory.cpu().numpy()
        self.directory, self.pk, self.pv = directory, pk, pv
        self.fused_q = [torch.tensor(cs.half_live(rng, live, 4608),
                                     device=dev) for _ in range(64)]
        wide = [cs.half_live(rng, live, 8 * 4608) for _ in range(64)]
        self.probe_q = [torch.tensor(q, device=dev) for q in wide]
        self.bids = [torch.tensor(cs.route_np(q, d_np, dmax).astype(
            np.int32), device=dev) for q in wide]
        self.found = torch.empty(8 * 4608, dtype=torch.bool, device=dev)
        self.vals = torch.empty(8 * 4608, dtype=torch.int32, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def fused_call(self, b: Build, block, i):
        q = self.fused_q[i % 64]
        rc = b.fused(self.directory.data_ptr(), q.data_ptr(),
                     self.pk.data_ptr(), self.pv.data_ptr(),
                     self.found.data_ptr(), self.vals.data_ptr(), q.shape[0],
                     self.pk.shape[1], cs.MAIN_SPEC["dmax"], 0, 0,
                     *([block] if b.block_arg else []), self.stream)
        cs.check(rc == 0, f"fused_probe launch: cudaError_t {rc}")

    def probe_call(self, b: Build, block, i):
        q, bid = self.probe_q[i % 64], self.bids[i % 64]
        rc = b.probe(bid.data_ptr(), q.data_ptr(), self.pk.data_ptr(),
                     self.pv.data_ptr(), self.found.data_ptr(),
                     self.vals.data_ptr(), q.shape[0], self.pk.shape[1],
                     *([block] if b.block_arg else []), self.stream)
        cs.check(rc == 0, f"probe launch: cudaError_t {rc}")

    def check_against_plain(self, name, b: Build, block):
        from repro_torch.kernels.lookup import fused_probe_plain, probe_plain
        for kernel, call, plain, args in (
                ("fused_probe", lambda: self.fused_call(b, block, 0),
                 lambda: fused_probe_plain(
                     self.directory, self.fused_q[0], self.pk, self.pv,
                     dmax=cs.MAIN_SPEC["dmax"]), self.fused_q[0]),
                ("probe", lambda: self.probe_call(b, block, 0),
                 lambda: probe_plain(self.bids[0], self.probe_q[0], self.pk,
                                     self.pv), self.probe_q[0])):
            call()
            pf, pv = plain()
            n = args.shape[0]
            torch.cuda.synchronize()
            cs.check(torch.equal(self.found[:n], pf)
                     and torch.equal(self.vals[:n], pv),
                     f"{name} {kernel} disagrees with its plain version")

    def times(self, b: Build, block):
        return {"fused_probe_warm_ms": cs.cuda_ms(
                    lambda i: self.fused_call(b, block, i), 200),
                "fused_probe_cold_ms": cs.cold_ms(
                    lambda i: self.fused_call(b, block, i), 200),
                "probe_warm_ms": cs.cuda_ms(
                    lambda i: self.probe_call(b, block, i), 200),
                "probe_cold_ms": cs.cold_ms(
                    lambda i: self.probe_call(b, block, i), 200)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another checkout's src/repro_torch/csrc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_timing: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    cs.emit({"gpu": cs.smi_line(), "torch": torch.__version__})
    from repro_torch.kernels.tuning import TileConfig
    builds = build(args.baseline)
    default = TileConfig().block
    runs = [(name, block) for name, b in builds.items() for block in b.blocks]

    inputs = Inputs(rng, *main_table(rng, dev), dev)
    for name, block in runs:
        inputs.check_against_plain(f"{name} block {block}", builds[name],
                                   block)
    x = torch.zeros(1, device=dev)
    floor = {"launch_floor_ms": cs.cuda_ms(lambda i: x.add_(1), 200),
             "launch_floor_cold_ms": cs.cold_ms(lambda i: x.add_(1), 200)}
    cs.emit({"phase": "floor", **floor})
    for rep, order in enumerate((runs, runs[::-1])):
        for name, block in order:
            cs.emit({"phase": "build_times", "build": name, "block": block,
                     "pass": rep, "default": name == "this"
                     and block == default,
                     **inputs.times(builds[name], block)})

    this = builds["this"]
    for B in (4, 8, 16, 32):
        directory, pk, pv, live = pools(rng, B, dev)
        paths = {"vector": (pk, pv),
                 "slot_by_slot": (cs.offset_by_one(pk.cpu().numpy(), dev),
                                  cs.offset_by_one(pv.cpu().numpy(), dev))}
        rows = {path: Inputs(np.random.default_rng(B), directory, k, v, live,
                             dev) for path, (k, v) in paths.items()}
        for path, r in rows.items():
            r.check_against_plain(f"{path} B={B}", this, default)
        for rep, names in enumerate((list(rows), list(rows)[::-1])):
            for path in names:
                cs.emit({"phase": "row_path", "B": B, "path": path,
                         "pass": rep, **rows[path].times(this, default)})
        del directory, pk, pv, paths, rows
        torch.cuda.empty_cache()
    cs.emit({"ok": True, "gpu": cs.smi_line()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
