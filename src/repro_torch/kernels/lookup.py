"""The fused lookup kernel: hash → directory route → bucket probe.

``fused_probe`` launches the hand-written CUDA kernel
(``csrc/fused_probe.cu``, one thread per query) for CUDA tensors and runs
``fused_probe_plain``, its plain PyTorch version, for CPU tensors. It
replaces the Pallas TPU kernel ``repro/kernels/lookup.py::fused_probe``,
whose one-hot MXU gathers bounded it to dmax <= 17 and fp32-exact rows,
and above that bound the XLA route plus the unfused ``probe`` kernel; the
CUDA kernel gathers directly and has no such bound.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import HASH_IDS, hash_fn
from repro_torch.core.table import probe
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_i32_vector, check_pools

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fused_probe_plain(directory, queries, pool_keys, pool_vals, *, dmax: int,
                      hash_name: str = "fmix32", hash_shift: int = 0):
    """Plain version of the kernel: same contract, same results."""
    return probe(directory, queries, pool_keys, pool_vals, dmax=dmax,
                 hash=hash_fn(hash_name, hash_shift))


def fused_probe(directory: torch.Tensor, queries: torch.Tensor,
                pool_keys: torch.Tensor, pool_vals: torch.Tensor, *,
                dmax: int, hash_name: str = "fmix32", hash_shift: int = 0):
    """Single-kernel lookup: hash, directory route and bucket probe fused.

    directory i32[2**dmax] (entry → pool row), queries i32[N], pool_keys /
    pool_vals i32[R, B] (the table passes its pools without the trash row).
    Returns (found bool[N], vals i32[N], -1 for misses); an ``EMPTY_KEY``
    query is never found. Directory entries must name rows below R."""
    if directory.shape != (1 << dmax,):
        raise ValueError(f"directory shape {tuple(directory.shape)} != "
                         f"(2**{dmax},)")
    check_i32_vector("directory", directory, directory.device)
    check_i32_vector("queries", queries, directory.device)
    check_pools(pool_keys, pool_vals, directory.device)
    if queries.device.type == "cpu":
        return fused_probe_plain(directory, queries, pool_keys, pool_vals,
                                 dmax=dmax, hash_name=hash_name,
                                 hash_shift=hash_shift)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_probe runs on cuda or cpu tensors, not "
                         f"{queries.device}")
    n = queries.shape[0]
    found = torch.empty(n, dtype=torch.bool, device=queries.device)
    vals = torch.empty(n, dtype=torch.int32, device=queries.device)
    launch = _build.load("fused_probe.cu", "fused_probe_launch", _ARGTYPES)
    rc = launch(directory.data_ptr(), queries.data_ptr(),
                pool_keys.data_ptr(), pool_vals.data_ptr(), found.data_ptr(),
                vals.data_ptr(), n, pool_keys.shape[1], dmax,
                HASH_IDS[hash_name], hash_shift,
                torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(rc, "fused_probe")
    fused_probe.launches += 1
    return found, vals


fused_probe.launches = 0
