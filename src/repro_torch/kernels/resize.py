"""The slow path of a kernel write transaction: the ops a kernel reported
``ST_FULL``, through the bounded split rounds, in one launch.

``resize_apply`` launches the hand-written CUDA kernel
``csrc/resize_apply.cu`` (one thread block that runs every round on the
device: no host read steers it, and its work is the pending lanes, the
buckets it splits and their directory ranges) for CUDA tensors, and runs
``core/table.py::apply_batch``, its plain version, for CPU tensors. It
replaces no TPU kernel: the JAX package's slow path is jnp code
(``src/repro/core/table.py::apply_batch``). It exists because the host, not
bytes, bounded this path on the card: the plain rounds dispatch hundreds of
PyTorch operations a call and read the device between passes.

Its contract is ``apply_batch(cfg, state, ops)`` on the batch that
``kernels/ops.py::_finish_kernel_apply`` builds, the ``ST_FULL`` lanes
with every other lane NOP: the same state, field by field, and the same
statuses, lane by lane. On such a batch the plain transaction's fast pass
applies nothing, so the kernel runs the rounds alone. One exception, once
the pool is exhausted: an op routed to the trash row stays ``PENDING``
(``error`` set) and row P is not written, where the plain passes apply it
to row P and report it applied though its item is lost.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import telemetry
from repro_torch.core import table as T
from repro_torch.core.hashing import HASH_IDS
from repro_torch.kernels import _build
from repro_torch.kernels._checks import (check_i32_vector, check_pools,
                                         check_tensor)

# the device counts the kernel writes, in order
STATS = ("slow.rounds", "slow.waves", "slow.splits")

# launches so far; kept on the module, so that a wrapper patched over
# ``resize_apply`` (a timer, a counter) leaves the count whole
launches = 0

_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.cache
def _scratch_bytes(n: int) -> int:
    fn = _build.load("resize_apply.cu", "resize_apply_scratch_bytes",
                     [ctypes.c_int], restype=ctypes.c_longlong)
    return int(fn(n))


def _check(cfg: T.TableConfig, st: T.TableState, ops: T.OpBatch, dev):
    n, P = cfg.n_lanes, cfg.pool_size
    for name, t in zip(ops._fields, ops):
        check_i32_vector(f"ops.{name}", t, dev, n)
    check_i32_vector("directory", st.directory, dev, cfg.dcap)
    check_pools(st.keys, st.vals, dev)
    check_tensor("keys", st.keys, torch.int32, dev,
                 shape=(P + 1, cfg.bucket_size))
    for name in ("bdepth", "bprefix", "free_stack", "counts"):
        check_i32_vector(name, getattr(st, name), dev, P + 1)
    for name in ("live", "frozen"):
        check_tensor(name, getattr(st, name), torch.bool, dev, shape=(P + 1,))
    for name in ("depth", "nalloc", "free_top"):
        check_tensor(name, getattr(st, name), torch.int32, dev, shape=())
    check_tensor("error", st.error, torch.bool, dev, shape=())
    check_i32_vector("applied_seq", st.applied_seq, dev, n)
    check_tensor("last_status", st.last_status, torch.int8, dev, shape=(n,))


def resize_apply(cfg: T.TableConfig, state: T.TableState, ops: T.OpBatch):
    """``T.apply_batch(cfg, state, ops)`` for a kernel transaction's
    ``ST_FULL`` ops (every other lane NOP): one launch on the card.

    The pools, the per-bucket arrays, the free stack and the directory are
    updated **in place**; ``depth``, ``nalloc``, ``free_top``, ``error``,
    ``applied_seq`` and ``last_status`` come back as new tensors. ``state``
    is consumed. Returns ``(state, BatchResult)`` as ``apply_batch`` does.
    Inside ``telemetry.collect()`` the kernel's rounds, waves and splits
    are added to ``slow.rounds``, ``slow.waves`` and ``slow.splits``
    without a sync. Each launch adds one to the module's ``launches``."""
    global launches
    dev = ops.kind.device
    _check(cfg, state, ops, dev)
    if dev.type == "cpu":
        return T.apply_batch(cfg, state, ops)
    if dev.type != "cuda":
        raise ValueError(f"resize_apply runs on cuda or cpu tensors, not "
                         f"{dev}")
    n = cfg.n_lanes
    with telemetry.span("repro.core.resize_apply"):
        status = torch.empty(n, dtype=torch.int8, device=dev)
        last_status = torch.empty(n, dtype=torch.int8, device=dev)
        applied_seq = torch.empty(n, dtype=torch.int32, device=dev)
        depth, nalloc, free_top = (torch.empty((), dtype=torch.int32,
                                               device=dev) for _ in range(3))
        error = torch.empty((), dtype=torch.bool, device=dev)
        stats = torch.empty(len(STATS), dtype=torch.int32, device=dev)
        extra = _scratch_bytes(n)
        scratch = (torch.empty(extra, dtype=torch.uint8, device=dev)
                   if extra else None)
        tensors = (state.directory, state.keys, state.vals, state.bdepth,
                   state.bprefix, state.live, state.frozen, state.free_stack,
                   state.counts, state.depth, state.nalloc, state.free_top,
                   state.error, state.applied_seq, state.last_status,
                   ops.kind, ops.key, ops.value, ops.seq, status, applied_seq,
                   last_status, depth, nalloc, free_top, error, stats,
                   scratch)
        ptrs = (ctypes.c_void_p * len(tensors))(
            *(None if t is None else t.data_ptr() for t in tensors))
        launch = _build.load("resize_apply.cu", "resize_apply_launch",
                             _ARGTYPES)
        rc = launch(ptrs, n, cfg.bucket_size, cfg.pool_size, cfg.dmax,
                    HASH_IDS[cfg.hash_name], cfg.hash_shift, cfg.rounds,
                    int(cfg.use_fast_path),
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "resize_apply")
        launches += 1
        telemetry.count_device(STATS, stats)
    st = state._replace(depth=depth, nalloc=nalloc, free_top=free_top,
                        error=error, applied_seq=applied_seq,
                        last_status=last_status)
    return st, T.BatchResult(status=status, error=error)
