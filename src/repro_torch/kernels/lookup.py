"""The lookup kernels: the fused probe and the pre-routed probe.

``fused_probe`` launches the hand-written CUDA kernel
(``csrc/fused_probe.cu``, one thread per query: hash → directory route →
bucket probe) for CUDA tensors and runs ``fused_probe_plain``, its plain
PyTorch version, for CPU tensors. It replaces the Pallas TPU kernel
``repro/kernels/lookup.py::fused_probe``, whose one-hot MXU gathers bounded
it to dmax <= 17 and fp32-exact rows; the CUDA kernel gathers directly and
has no such bound.

``probe`` launches ``csrc/probe.cu`` (one thread per query over bucket ids
routed beforehand) for CUDA tensors and runs ``probe_plain`` for CPU
tensors. It replaces the Pallas TPU kernel ``repro/kernels/lookup.py::probe``
and serves the tables whose plan routes lookups outside the fused kernel
(``kernels/plan.py``). Both kernels share one row probe
(``csrc/row_probe.cuh``), as both plain versions share
``core/table.py::probe_rows``, and one launch shape: ``block`` threads a
block, one of ``kernels/tuning.py::BLOCKS`` (64 unless the table's plan
says otherwise). A block size outside that set raises ``ValueError``
before any launch; the plain versions take the argument and ignore it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import table as T
from repro_torch.core.hashing import HASH_IDS, hash_fn
from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_i32_vector, check_pools
from repro_torch.kernels.tuning import TileConfig, check_block

_FUSED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
_PROBE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
# threads a probe block unless the plan says otherwise
DEFAULT_BLOCK = TileConfig().block


def _outputs(n: int, device):
    return (torch.empty(n, dtype=torch.bool, device=device),
            torch.empty(n, dtype=torch.int32, device=device))


def fused_probe_plain(directory, queries, pool_keys, pool_vals, *, dmax: int,
                      hash_name: str = "fmix32", hash_shift: int = 0,
                      block: int = DEFAULT_BLOCK):
    """Plain version of the kernel: same contract, same results (``block``
    is ignored)."""
    return T.probe(directory, queries, pool_keys, pool_vals, dmax=dmax,
                   hash=hash_fn(hash_name, hash_shift))


def fused_probe(directory: torch.Tensor, queries: torch.Tensor,
                pool_keys: torch.Tensor, pool_vals: torch.Tensor, *,
                dmax: int, hash_name: str = "fmix32", hash_shift: int = 0,
                block: int = DEFAULT_BLOCK):
    """Single-kernel lookup: hash, directory route and bucket probe fused.

    directory i32[2**dmax] (entry → pool row), queries i32[N], pool_keys /
    pool_vals i32[R, B] (the table passes its pools without the trash row),
    ``block`` threads a block. Returns (found bool[N], vals i32[N], -1 for
    misses); an ``EMPTY_KEY`` query is never found. Directory entries must
    name rows below R."""
    check_block(block)
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
    found, vals = _outputs(queries.shape[0], queries.device)
    launch = _build.load("fused_probe.cu", "fused_probe_launch",
                         _FUSED_ARGTYPES)
    rc = launch(directory.data_ptr(), queries.data_ptr(),
                pool_keys.data_ptr(), pool_vals.data_ptr(), found.data_ptr(),
                vals.data_ptr(), queries.shape[0], pool_keys.shape[1], dmax,
                HASH_IDS[hash_name], hash_shift, int(block),
                torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(rc, "fused_probe")
    fused_probe.launches += 1
    return found, vals


fused_probe.launches = 0


def probe_plain(bucket_ids, queries, pool_keys, pool_vals, *,
                block: int = DEFAULT_BLOCK):
    """Plain version of the pre-routed probe: same contract, same results
    (``core/table.py::probe_rows``; ``block`` is ignored)."""
    return T.probe_rows(bucket_ids, queries, pool_keys, pool_vals)


def probe(bucket_ids: torch.Tensor, queries: torch.Tensor,
          pool_keys: torch.Tensor, pool_vals: torch.Tensor, *,
          block: int = DEFAULT_BLOCK):
    """Probe of pre-routed rows: query i looks in row ``bucket_ids[i]``.

    bucket_ids / queries i32[N]; pool_keys / pool_vals i32[R, B] (the table
    passes its pools without the trash row), with every bucket id below R;
    ``block`` threads a block. Returns (found bool[N], vals i32[N], -1
    for misses): found where some slot of the row equals the query, the
    first such slot's value. An ``EMPTY_KEY`` query is never found, as in
    the Pallas kernel; where a row holds a key twice (the table never
    does) the Pallas kernel sums the matching values and this one takes
    the first."""
    check_block(block)
    dev = queries.device
    check_i32_vector("bucket_ids", bucket_ids, dev)
    check_i32_vector("queries", queries, dev, bucket_ids.shape[0])
    check_pools(pool_keys, pool_vals, dev)
    if dev.type == "cpu":
        return probe_plain(bucket_ids, queries, pool_keys, pool_vals)
    if dev.type != "cuda":
        raise ValueError(f"probe runs on cuda or cpu tensors, not {dev}")
    found, vals = _outputs(queries.shape[0], dev)
    launch = _build.load("probe.cu", "probe_launch", _PROBE_ARGTYPES)
    rc = launch(bucket_ids.data_ptr(), queries.data_ptr(),
                pool_keys.data_ptr(), pool_vals.data_ptr(), found.data_ptr(),
                vals.data_ptr(), queries.shape[0], pool_keys.shape[1],
                int(block), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "probe")
    probe.launches += 1
    return found, vals


probe.launches = 0
