"""The apply kernels: the fused write transaction and the grouped apply.

``fused_apply`` launches the hand-written CUDA kernel
(``csrc/fused_apply.cu``: one thread block per transaction) for CUDA
tensors and runs ``fused_apply_plain``, its plain PyTorch version, for CPU
tensors. It replaces the Pallas TPU kernel
``repro/kernels/apply.py::fused_apply``, with the contract of
``repro/kernels/ref.py::fused_apply_ref``; its bound is its own (one block
of at most 1024 lanes, rows of at most 32 slots).

``grouped_apply`` launches ``csrc/grouped_apply.cu`` (one thread block
working through the batch chunk after chunk, in lane order; ``chunk`` lanes
a chunk, one of ``kernels/tuning.py::CHUNKS``, 4,096 unless the table's
plan says otherwise, and anything else raises ``ValueError`` before any
launch) for CUDA tensors and runs ``grouped_apply_plain`` for CPU tensors.
It replaces the Pallas TPU kernel ``repro/kernels/apply.py::grouped_apply``,
with the contract of ``repro/kernels/ref.py::apply_ref``, takes its ops in
any order, and serves the transactions beyond the fused kernel's bound
(``kernels/plan.py``). Both kernels group a chunk's ops by bucket with one
core (``csrc/lane_groups.cuh``: a stable block radix sort in shared
memory) and share one combine step (``csrc/bucket_row.cuh``), as both plain
versions share ``core/table.py::wave_combine``.

Ops never resize here: an op that meets a full bucket reports ``ST_FULL``
and is left to the bounded split rounds of ``kernels/resize.py`` (on CPU
tensors ``core/table.py::apply_batch``), the paper's FAIL → ResizeWF slow
path, wired in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hashing import HASH_IDS, dir_index, hash_fn
from repro_torch.core.table import wave_combine
from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_i32_vector, check_pools,
                                         check_tensor)
from repro_torch.kernels.tuning import TileConfig, check_chunk

# status codes shared with the kernel (ST_FROZEN == table.FROZEN)
ST_IDLE = -1
ST_FALSE = 0
ST_TRUE = 1
ST_FROZEN = -2
ST_FULL = -3

# the fused kernel's geometry: one block takes the whole transaction as one
# chunk of the grouping core, and a run's owner keeps its bucket row in
# registers
MAX_LANES = 1024
MAX_BUCKET_SIZE = 32
# lanes per chunk of csrc/grouped_apply.cu unless the plan says otherwise
# (a batch wider than its chunk is worked through chunk after chunk)
GROUPED_CHUNK = TileConfig().chunk

_FUSED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_GROUPED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])


def fused_apply_supported(n_lanes: int, bucket_size: int) -> bool:
    return 0 < n_lanes <= MAX_LANES and 0 < bucket_size <= MAX_BUCKET_SIZE


def fused_apply_plain(directory, frozen, kinds, keys, values, pool_keys,
                      pool_vals, *, dmax: int, hash_name: str = "fmix32",
                      hash_shift: int = 0):
    """Plain version of the kernel, the contract of ``fused_apply_ref``:
    ops apply in lane order. It is the plain transaction's wave loop
    (``core/table.py::wave_combine``) with the kernel's statuses."""
    bids = directory[dir_index(hash_fn(hash_name, hash_shift)(keys), dmax)]
    applied, full, _, exist = wave_combine(
        pool_keys, pool_vals, frozen, bids, (kinds == 1) | (kinds == 2),
        kinds, keys, values)
    status = torch.where(kinds == 0, ST_IDLE, ST_FROZEN)
    status = torch.where(applied, torch.where(kinds == 1, ~exist, exist)
                         .to(torch.int32), status)
    status = torch.where(full, ST_FULL, status).to(torch.int32)
    return pool_keys, pool_vals, status, bids


def fused_apply(directory: torch.Tensor, frozen: torch.Tensor,
                kinds: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, pool_keys: torch.Tensor,
                pool_vals: torch.Tensor, *, dmax: int,
                hash_name: str = "fmix32", hash_shift: int = 0):
    """The fused combining write transaction, one kernel launch.

    directory i32[2**dmax]; frozen bool[P+1]; kinds i32[n] (0 = idle,
    1 = insert/upsert, 2 = delete), keys / values i32[n]; pool_keys /
    pool_vals the FULL [P+1, B] pools, trash row included.

    The pools are updated **in place** and returned: the caller's previous
    pool tensors (and a ``TableState`` holding them) are consumed. Returns
    (pool_keys, pool_vals, status i32[n], bucket_ids i32[n]) with status in
    {ST_TRUE, ST_FALSE, ST_FULL, ST_FROZEN, ST_IDLE}. The trash row's
    content is unspecified afterwards. Geometry bound: 1 <= n <= 1024 and
    B <= 32 (``fused_apply_supported``)."""
    dev = directory.device
    n = kinds.shape[0]
    if directory.shape != (1 << dmax,):
        raise ValueError(f"directory shape {tuple(directory.shape)} != "
                         f"(2**{dmax},)")
    check_i32_vector("directory", directory, dev)
    check_pools(pool_keys, pool_vals, dev)
    check_tensor("frozen", frozen, torch.bool, dev,
                 shape=(pool_keys.shape[0],))
    for name, t in (("kinds", kinds), ("keys", keys), ("values", values)):
        check_i32_vector(name, t, dev, n)
    if dev.type == "cpu":
        return fused_apply_plain(directory, frozen, kinds, keys, values,
                                 pool_keys, pool_vals, dmax=dmax,
                                 hash_name=hash_name, hash_shift=hash_shift)
    if dev.type != "cuda":
        raise ValueError(f"fused_apply runs on cuda or cpu tensors, not "
                         f"{dev}")
    if not fused_apply_supported(n, pool_keys.shape[1]):
        raise ValueError(f"geometry outside the fused-apply kernel: "
                         f"n={n} (max {MAX_LANES}), B={pool_keys.shape[1]} "
                         f"(max {MAX_BUCKET_SIZE})")
    status = torch.empty(n, dtype=torch.int32, device=dev)
    bids = torch.empty(n, dtype=torch.int32, device=dev)
    launch = _build.load("fused_apply.cu", "fused_apply_launch",
                         _FUSED_ARGTYPES)
    rc = launch(directory.data_ptr(), frozen.data_ptr(), kinds.data_ptr(),
                keys.data_ptr(), values.data_ptr(), pool_keys.data_ptr(),
                pool_vals.data_ptr(), status.data_ptr(), bids.data_ptr(), n,
                pool_keys.shape[1], dmax, HASH_IDS[hash_name], hash_shift,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_apply")
    fused_apply.launches += 1
    return pool_keys, pool_vals, status, bids


fused_apply.launches = 0


def grouped_apply_plain(kinds, keys, values, bucket_ids, pool_keys,
                        pool_vals, *, chunk: int = GROUPED_CHUNK):
    """Plain version of the grouped apply, the contract of ``apply_ref``:
    ops apply in index order, in any input order. It is the plain
    transaction's wave loop (``core/table.py::wave_combine``) with no bucket
    frozen; within a bucket the wave order is index order, and ops on
    distinct buckets commute. The trash row takes the idle lanes'
    writes; ``chunk`` is ignored."""
    update = (kinds == 1) | (kinds == 2)
    frozen = torch.zeros(pool_keys.shape[0], dtype=torch.bool,
                         device=kinds.device)
    applied, full, _, exist = wave_combine(
        pool_keys, pool_vals, frozen, bucket_ids, update, kinds, keys,
        values)
    status = torch.where(applied, torch.where(kinds == 1, ~exist, exist)
                         .to(torch.int8), ST_IDLE)
    status = torch.where(full, ST_FULL, status).to(torch.int8)
    return pool_keys, pool_vals, status


def grouped_apply(kinds: torch.Tensor, keys: torch.Tensor,
                  values: torch.Tensor, bucket_ids: torch.Tensor,
                  pool_keys: torch.Tensor, pool_vals: torch.Tensor, *,
                  chunk: int = GROUPED_CHUNK):
    """Combining apply of ops in any order, any batch width, ``chunk``
    lanes a chunk.

    kinds i32[M] (0 = idle, 1 = insert/upsert, 2 = delete), keys / values
    i32[M], bucket_ids i32[M] (the pool row of each op, below P); pool_keys
    / pool_vals the FULL [P+1, B] pools, trash row included, where the JAX
    kernel takes the [P, B] pools without it. Ops apply as if one by one in
    index order, the full test first (``ST_FULL`` even for a delete); the
    kernel ignores freezing, so the caller completes frozen ops. The ops
    need no sorting: the active ops of one bucket may lie anywhere in the
    batch, with other ops between them; idle ops may carry any bucket id.

    The pools are updated **in place** and returned: the caller's previous
    pool tensors (and a ``TableState`` holding them) are consumed. Returns
    (pool_keys, pool_vals, status i8[M]) with status in {ST_TRUE,
    ST_FALSE, ST_FULL, ST_IDLE}. The kernel never writes the trash row;
    the plain version may."""
    check_chunk(chunk)
    dev = kinds.device
    m = kinds.shape[0]
    check_pools(pool_keys, pool_vals, dev)
    for name, t in (("kinds", kinds), ("keys", keys), ("values", values),
                    ("bucket_ids", bucket_ids)):
        check_i32_vector(name, t, dev, m)
    if dev.type == "cpu":
        return grouped_apply_plain(kinds, keys, values, bucket_ids,
                                   pool_keys, pool_vals)
    if dev.type != "cuda":
        raise ValueError(f"grouped_apply runs on cuda or cpu tensors, not "
                         f"{dev}")
    status = torch.empty(m, dtype=torch.int8, device=dev)
    launch = _build.load("grouped_apply.cu", "grouped_apply_launch",
                         _GROUPED_ARGTYPES)
    rc = launch(kinds.data_ptr(), keys.data_ptr(), values.data_ptr(),
                bucket_ids.data_ptr(), pool_keys.data_ptr(),
                pool_vals.data_ptr(), status.data_ptr(), m,
                pool_keys.shape[1], pool_keys.shape[0], int(chunk),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "grouped_apply")
    grouped_apply.launches += 1
    return pool_keys, pool_vals, status


grouped_apply.launches = 0
