"""The payload bytes a record must read back, in plain NumPy.

Record bytes are the benchmark's input data: a hash of (seed, key,
version) that the generator makes on the device. This is a second,
independent implementation of the same definition in unsigned 32-bit
NumPy arithmetic (a CPU test holds the two equal), so that the reference
never reads bytes the program has stored.
"""
from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF
S_VALUE = 5


def _fmix_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def stream_key(seed: int, stream: int, rnd: int = 0) -> int:
    h = _fmix_int(stream * 0x9E3779B1 + 0x6A09E667)
    s = int(seed)
    for word in (s & MASK32, (s >> 32) & MASK32, (s >> 64) & MASK32,
                 1 if s < 0 else 0, rnd & MASK32, (rnd >> 32) & MASK32):
        h = _fmix_int(h ^ _fmix_int(word + 0x3C6EF372))
    return h


def fmix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def record_bytes(seed: int, keys: np.ndarray, versions: np.ndarray,
                 n_bytes: int) -> np.ndarray:
    """``[m, n_bytes]`` uint8: the bytes of each (key, version)."""
    base = np.uint32(stream_key(seed, S_VALUE, -1))
    keys = keys.astype(np.int64).astype(np.uint32)
    kv = fmix32(fmix32(keys ^ base)
                ^ versions.astype(np.int64).astype(np.uint32))
    n_words = -(-n_bytes // 4)
    j = np.arange(1, n_words + 1, dtype=np.uint32)
    words = fmix32(kv[:, None] ^ (j * np.uint32(0x9E3779B1))[None, :])
    return words.astype("<u4").view(np.uint8).reshape(
        keys.size, 4 * n_words)[:, :n_bytes]
