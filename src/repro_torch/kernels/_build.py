"""Build the CUDA kernels on first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All missing libraries build at once, one ``nvcc`` process per
source, into ``build/repro_torch/<hash of the sources and flags>/`` under
the repository root; a changed source gets a fresh directory. Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_probe.cu", "fused_apply.cu", "probe.cu",
           "grouped_apply.cu", "resize_apply.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (source, fn) -> the C entry point with its argument types set
_entry_points: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(source: str) -> Path:
    return build_dir() / (Path(source).stem + ".so")


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds spent; the compiler's report (registers, shared
    memory, spills) is kept beside each library as ``<name>.log``."""
    out = build_dir()
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        lib = _lib_path(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / src)]
        jobs.append((src, lib, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{src} (see {lib.with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return time.perf_counter() - t0


def load(source: str, fn: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``fn`` of ``source``'s library, built if needed,
    with its argument types declared (pointers and the stream as
    ``c_void_p``, integers as ``c_int``); it returns ``restype``, a
    cudaError_t unless the caller says otherwise. The library is opened
    and the types are set once per ``(source, fn)``; later calls return the
    same entry point."""
    f = _entry_points.get((source, fn))
    if f is None:
        build_all()
        f = getattr(ctypes.CDLL(str(_lib_path(source))), fn)
        f.argtypes = argtypes
        f.restype = restype
        _entry_points[(source, fn)] = f
    return f


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
