"""Bit-string hashing utilities for extendible hashing (paper §3), in torch.

Extendible hashing treats hash values as bit strings; the top ``depth`` bits
of a key's hash select its directory entry. The arithmetic is uint32 with
wrap-around. PyTorch has no ``>>`` for ``uint32`` on the CPU, so hashes are
carried as **int64 tensors holding values in [0, 2**32)**: every step masks
back to 32 bits, and the two multiplications are split into 16-bit halves
so no intermediate leaves the int64 range (``_mul32``).
"""
from __future__ import annotations

import numpy as np
import torch

HASH_BITS = 32
MASK32 = 0xFFFFFFFF
# INT32_MIN marks an empty bucket slot. The key space is all int32 except
# this sentinel.
EMPTY_KEY = -2147483648

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or any int) bits → int64 in [0, 2**32)."""
    return x.to(torch.int64) & MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for h in [0, 2**32): the high half of ``c``
    only contributes its product's low 16 bits, shifted up by 16, so every
    partial product stays below 2**48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer (bijective on 32 bits); int64 result."""
    h = _u32(x)
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    h = h ^ (h >> 16)
    return h


def identity_hash(x: torch.Tensor) -> torch.Tensor:
    """Key bits used directly as the hash (tests use this to force layouts)."""
    return _u32(x)


HASH_FNS = {"fmix32": fmix32, "identity": identity_hash}
# integer ids the CUDA kernels take for ``hash_name``
HASH_IDS = {"fmix32": 0, "identity": 1}


def hash_fn(hash_name: str, hash_shift: int = 0):
    """The table's hash: ``HASH_FNS[hash_name]`` with the top ``hash_shift``
    bits shifted out (sharded tables; 0 for local placement)."""
    base = HASH_FNS[hash_name]
    if hash_shift:
        return lambda x: (base(x) << hash_shift) & MASK32
    return base


def hash_np(hash_name: str, keys: np.ndarray, shift: int = 0) -> np.ndarray:
    """Host-side numpy mirror of ``HASH_FNS`` (+ ``hash_shift``), uint32."""
    h = np.asarray(keys).astype(np.uint32)
    if hash_name != "identity":
        assert hash_name == "fmix32", hash_name
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(_C1)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(_C2)
        h = h ^ (h >> np.uint32(16))
    if shift:
        h = h << np.uint32(shift)
    return h


def prefix(h: torch.Tensor, depth) -> torch.Tensor:
    """Top ``depth`` bits of ``h`` (paper's ``Prefix(key, depth)``), int32.

    ``depth`` may be an int or an integer tensor; depth == 0 yields 0."""
    depth = torch.as_tensor(depth, dtype=torch.int64, device=h.device)
    shifted = h >> torch.clamp(HASH_BITS - depth, max=31)
    return torch.where(depth == 0, torch.zeros_like(shifted),
                       shifted).to(torch.int32)


def dir_index(h: torch.Tensor, dmax: int) -> torch.Tensor:
    """Physical directory index: top ``dmax`` bits (capacity 2**dmax)."""
    assert 1 <= dmax <= 31
    return (h >> (HASH_BITS - dmax)).to(torch.int64)


def child_bit(h: torch.Tensor, parent_depth) -> torch.Tensor:
    """Bit selecting child 0/1 when a bucket of ``parent_depth`` splits:
    bit number ``parent_depth`` counted from the MSB, as int32 (0 past the
    32nd bit, as a uint32 shift by 32 or more gives in XLA)."""
    shift = HASH_BITS - 1 - torch.as_tensor(parent_depth, dtype=torch.int64,
                                            device=h.device)
    bit = (h >> shift.clamp(min=0)) & 1
    return torch.where(shift < 0, 0, bit).to(torch.int32)
