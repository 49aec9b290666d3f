"""The general traffic generator: every op a pure function of (seed, round).

A traffic file (``traffic/<name>.json``) holds parameters only; this module
turns them into the ops of one round, on whatever device it is asked for,
with integer hashing that gives the same bits on the CPU and on the card.
Nothing here keeps state between rounds: round ``r`` of seed ``s`` is the
same wherever and whenever it is made.

Key spaces (from the configuration's ``keys``):

* ``{"universe": R, "preload": "half"}``: the paper's evaluation. Keys are
  R distinct int32 values, a seeded bijective scatter of the indices
  ``[0, R)`` over ``[1, 2**30]``; a seeded half of them is loaded.
  ``uniform`` picks any index of the universe.
* ``{"records": N}``: YCSB. Record ``n`` has the key of a seeded 31-bit
  bijection of ``n``; records ``[0, N)`` are loaded, then each is updated
  once (version :meth:`Traffic.settle_versions`). The live window is
  ``[lo, hi)``, and a round's ``new`` inserts and ``oldest`` deletes move it.
  ``uniform``, ``zipfian`` (oldest records hottest: YCSB's request
  distribution over record numbers that the key bijection scatters) and
  ``latest`` (newest hottest) pick inside the window.

A round is ``reads`` (lookups, issued first) and ``writes``: ops of the
kinds given, their lanes in a seeded order, sent as one ``Table.apply`` or,
for ``"call": "update"``, one ``Table.update``. ``zipfian`` and ``latest``
take the file's one top-level ``theta``. Values: a hashed int32 in
raw mode; in schema mode the payload bytes are :func:`payload_words` of
(seed, key, version), version ``round * W + lane + 1`` (0 for the load).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INS, DEL = 1, 2
# hash streams: one per independent draw
S_PRELOAD, S_READ, S_WRITE, S_SHUFFLE, S_VALUE, S_SAMPLE, S_KEYMAP = range(1, 8)
PICKS = ("uniform", "zipfian", "latest", "new", "oldest")
KINDS = {"insert": INS, "delete": DEL, "update": INS}
# reads a round whose payload records return to the host for the check
SAMPLE_READS = 16
PAYLOAD_ROWS = 1024


# ---------------------------------------------------------------------------
# 32-bit integer hashing in int64 tensors (exact on every device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x < 2**32, every product under 2**63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding u32."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _fmix_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def stream_key(seed: int, stream: int, rnd: int = 0) -> int:
    """A 32-bit key for one (seed, stream, round): seeds of any size."""
    h = _fmix_int(stream * 0x9E3779B1 + 0x6A09E667)
    s = int(seed)
    for word in (s & MASK32, (s >> 32) & MASK32, (s >> 64) & MASK32,
                 1 if s < 0 else 0, rnd & MASK32, (rnd >> 32) & MASK32):
        h = _fmix_int(h ^ _fmix_int(word + 0x3C6EF372))
    return h


def hash_at(key: int, idx: torch.Tensor) -> torch.Tensor:
    """u32 hash of each index under a stream key (int64 tensor)."""
    return fmix32(fmix32(idx.to(torch.int64) ^ key) + 0x7F4A7C15)


def uniform01(key: int, idx: torch.Tensor) -> torch.Tensor:
    """Float64 in [0, 1) with 53 hashed bits per index: exact everywhere."""
    a = hash_at(key, idx) >> 5
    b = hash_at(key ^ 0x5BD1E995, idx) >> 6
    return (a * 67108864 + b).to(torch.float64) * (2.0 ** -53)


def bijection(x: torch.Tensor, bits: int, key: int) -> torch.Tensor:
    """A seeded bijection of ``[0, 2**bits)``: xor, then xorshift-multiply
    rounds with odd multipliers, every step invertible mod 2**bits."""
    m = (1 << bits) - 1
    x = (x.to(torch.int64) ^ (key & m)) & m
    for mul in (0x2C1B3C6D, 0x297A2D39):
        x = x ^ (x >> (bits // 2))
        x = (x * (mul & m | 1)) & m
    return x ^ (x >> (bits // 2))


# ---------------------------------------------------------------------------
# payloads


def payload_words(seed: int, keys: torch.Tensor, versions: torch.Tensor,
                  n_words: int) -> torch.Tensor:
    """``[m, n_words]`` u32 words (in int64) of the payloads of
    ``(key, version)``: word j is a hash of (seed, key, version, j)."""
    base = stream_key(seed, S_VALUE, -1)
    kv = fmix32(fmix32(keys.to(torch.int64) & MASK32 ^ base)
                ^ (versions.to(torch.int64) & MASK32))
    j = torch.arange(n_words, dtype=torch.int64, device=keys.device)
    return fmix32(kv[:, None] ^ _mul32(j + 1, 0x9E3779B1)[None, :])


def payload_bytes(seed: int, keys, versions, n_bytes: int) -> torch.Tensor:
    """``[m, n_bytes]`` uint8: the little-endian bytes of the words (both
    the host and the card are little-endian), made ``PAYLOAD_ROWS``
    records at a time so that the int64 temporaries stay small beside the
    output (the peak memory is the program's to show)."""
    rows = PAYLOAD_ROWS
    m, n_words = keys.shape[0], -(-n_bytes // 4)
    out = torch.empty((m, 4 * n_words), dtype=torch.uint8,
                      device=keys.device)
    for a in range(0, m, rows):
        words = payload_words(seed, keys[a:a + rows], versions[a:a + rows],
                              n_words)
        words = (words - ((words >> 31) << 32)).to(torch.int32)
        out[a:a + rows] = words.view(torch.uint8).reshape(words.shape[0], -1)
    return out[:, :n_bytes]


def split_fields(rows: torch.Tensor, fields) -> dict:
    """``[m, total]`` payload bytes → ``{field: [m, *shape]}`` views in
    field order (each field's bytes in declaration order)."""
    out, at = {}, 0
    for name, shape in fields:
        size = int(np.prod(shape))
        out[name] = rows[:, at:at + size].reshape((rows.shape[0],)
                                                  + tuple(shape))
        at += size
    return out


# ---------------------------------------------------------------------------
# the traffic of one cell


@dataclasses.dataclass
class Round:
    """One round's ops on the device. ``read_idx`` / ``write_idx`` are the
    key-space indices (universe index or record number) of the ops, the
    encoding the reference works in; the table gets the keys."""

    reads: torch.Tensor          # i32[R] lookup keys
    read_idx: torch.Tensor       # i64[R]
    kinds: torch.Tensor          # i32[W]
    keys: torch.Tensor           # i32[W]
    write_idx: torch.Tensor      # i64[W]
    values: torch.Tensor         # i32[W] raw values
    versions: torch.Tensor       # i64[W] payload versions
    sample: torch.Tensor         # i64[K] read positions whose payloads return


class Traffic:
    """The ops of one (configuration, traffic) pair, per (seed, round)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        keys = config["keys"]
        self.universe = keys.get("universe")
        self.records = keys.get("records")
        if (self.universe is None) == (self.records is None):
            raise ValueError("keys: give exactly one of universe, records")
        self.reads = traffic["reads"]
        self.writes = traffic["writes"]
        self.call = self.writes.get("call", "apply")
        self.ops = self.writes["ops"]
        for spec in [self.reads] + self.ops:
            if spec["pick"] not in PICKS:
                raise ValueError(f"unknown pick {spec['pick']!r}")
        for op in self.ops:
            if op["kind"] not in KINDS:
                raise ValueError(f"unknown write kind {op['kind']!r}")
            if self.universe is not None and op["pick"] != "uniform":
                raise ValueError("a universe key space picks uniformly")
        if self.call == "update" and any(o["kind"] != "update"
                                         for o in self.ops):
            raise ValueError("an update call carries only updates")
        self.n_reads = int(self.reads["count"])
        self.n_writes = sum(int(o["count"]) for o in self.ops)
        self.grow = sum(int(o["count"]) for o in self.ops
                        if o["pick"] == "new")
        self.shrink = sum(int(o["count"]) for o in self.ops
                          if o["pick"] == "oldest")
        skewed = any(s["pick"] in ("zipfian", "latest")
                     for s in [self.reads] + self.ops)
        if skewed and self.grow != self.shrink:
            raise ValueError("zipfian/latest need a live window of fixed "
                             "size: as many new inserts as oldest deletes")
        self.sample_reads = min(SAMPLE_READS, self.n_reads)
        self._cdf = None
        if skewed:
            if "theta" not in traffic:
                raise ValueError("zipfian/latest need the file's theta")
            self._cdf = zipf_cdf(self.records, float(traffic["theta"]),
                                 self.device)
        self._kmap = stream_key(self.seed, S_KEYMAP)

    # -- key spaces --------------------------------------------------------

    def key_of(self, idx: torch.Tensor) -> torch.Tensor:
        """int32 keys of key-space indices (never the empty-slot key)."""
        if self.universe is not None:
            bits = 30
            return (bijection(idx, bits, self._kmap) + 1).to(torch.int32)
        return bijection(idx, 31, self._kmap).to(torch.int32)

    def window(self, rnd: int):
        """(lo, hi) of the live records before round ``rnd``."""
        return self.shrink * rnd, self.records + self.grow * rnd

    def preload_idx(self) -> torch.Tensor:
        """Indices loaded in set-up: a seeded half of the universe (the
        smallest hashes), or every record of ``[0, N)``."""
        if self.universe is not None:
            i = torch.arange(self.universe, dtype=torch.int64,
                             device=self.device)
            h = hash_at(stream_key(self.seed, S_PRELOAD), i)
            order = torch.sort((h << 31) | i).values & ((1 << 31) - 1)
            return torch.sort(order[:self.universe // 2]).values
        return torch.arange(self.records, dtype=torch.int64,
                            device=self.device)

    def settle_versions(self, idx: torch.Tensor) -> torch.Tensor:
        """Versions (payload) or values (raw) of the update that set-up
        sends every loaded record after the load: ``2**31 - 1 - idx``,
        above any round's version."""
        return (1 << 31) - 1 - idx

    def preload_values(self, idx: torch.Tensor) -> torch.Tensor:
        """Raw values of the loaded keys."""
        return (hash_at(stream_key(self.seed, S_VALUE, -2), idx)
                >> 1).to(torch.int32)

    def _pick(self, spec: dict, n: int, rnd: int, stream: int, off: int,
              at_new: int, at_old: int):
        i = torch.arange(off, off + n, dtype=torch.int64, device=self.device)
        key = stream_key(self.seed, stream, rnd)
        pick = spec["pick"]
        if self.universe is not None:
            return hash_at(key, i) % self.universe
        lo, hi = self.window(rnd)
        if pick == "uniform":
            return lo + hash_at(key, i) % (hi - lo)
        if pick in ("zipfian", "latest"):
            u = uniform01(key, i)
            rank = torch.searchsorted(self._cdf, u, right=True)
            rank = rank.clamp(max=self.records - 1)
            return lo + rank if pick == "zipfian" else hi - 1 - rank
        if pick == "new":
            return hi + at_new + torch.arange(n, device=self.device)
        return lo + at_old + torch.arange(n, device=self.device)

    def round(self, rnd: int) -> Round:
        """The ops of round ``rnd`` on the generator's device."""
        read_idx = self._pick(self.reads, self.n_reads, rnd, S_READ, 0, 0, 0)
        kinds, idx, off, at_new, at_old = [], [], 0, 0, 0
        for op in self.ops:
            n = int(op["count"])
            idx.append(self._pick(op, n, rnd, S_WRITE, off, at_new, at_old))
            kinds.append(torch.full((n,), KINDS[op["kind"]],
                                    dtype=torch.int32, device=self.device))
            off += n
            at_new += n if op["pick"] == "new" else 0
            at_old += n if op["pick"] == "oldest" else 0
        kinds, idx = torch.cat(kinds), torch.cat(idx)
        lanes = torch.arange(self.n_writes, dtype=torch.int64,
                             device=self.device)
        h = hash_at(stream_key(self.seed, S_SHUFFLE, rnd), lanes)
        perm = torch.sort((h << 20) | lanes).values & ((1 << 20) - 1)
        kinds, idx = kinds[perm], idx[perm]
        versions = rnd * self.n_writes + lanes + 1
        values = (hash_at(stream_key(self.seed, S_VALUE, rnd), lanes)
                  >> 1).to(torch.int32)
        sample = hash_at(stream_key(self.seed, S_SAMPLE, rnd),
                         torch.arange(self.sample_reads, device=self.device)
                         ) % self.n_reads
        return Round(reads=self.key_of(read_idx), read_idx=read_idx,
                     kinds=kinds, keys=self.key_of(idx), write_idx=idx,
                     values=values, versions=versions, sample=sample)


def zipf_cdf(n: int, theta: float, device) -> torch.Tensor:
    """The CDF of ranks ``0..n-1`` with weight ``1 / (rank + 1)**theta``,
    computed on the host in float64 (a sequential sum: the same bits on
    every device it is sent to)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -theta
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    cdf[-1] = 1.0
    return torch.tensor(cdf, dtype=torch.float64, device=device)
