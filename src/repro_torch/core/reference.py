"""Paper-literal sequential oracle for the wait-free extendible hash table.

A copy of the JAX package's ``repro/core/reference.py`` (numpy only), so
that the port checks itself against the same oracles without importing
that package. This is a direct Python transcription of the paper's pseudocode semantics
(Figures 5 & 6) executed sequentially: each operation is applied atomically
in a given order; an update that finds its destination bucket full FAILs,
splits the bucket (SplitBucket + DirectoryUpdate, repeatedly while the new
destination is full — the ApplyPendingResize while-loop), and then applies.

It is used to (a) check single-op sequential equivalence of the table,
and (b) enumerate legal linearizations for small concurrent batches, i.e. a
genuine linearizability test.

Two oracles live here:

* :class:`SeqExtHash` — the materialize-everything transcription: a real
  directory, real buckets, real splits. Structurally faithful (``layout()``
  can be compared against a device table) but its per-op cost is dominated
  by directory writes during splits: building n items costs
  O(dmax * 2**dmax) Python list stores, which caps checked traces at a few
  hundred thousand ops.
* :class:`StreamingOracle` — the bounded-memory equivalent for statuses and
  content only. It exploits the fact that in the sequential table every
  op's status is a pure function of the live *content*, not of the split
  history (see the class docstring for the argument), so it needs no
  directory at all: a live-set dict, per-prefix group counts, and a rolling
  64-bit multiset content digest. O(1) per op — million-op differential
  traces become routine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


HASH_BITS = 32
EMPTY = None

TRUE, FALSE = 1, 0
OVERFLOW = -3


def _fmix32(x: int) -> int:
    h = x & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _identity(x: int) -> int:
    return x & 0xFFFFFFFF


_HASHES = {"fmix32": _fmix32, "identity": _identity}


@dataclasses.dataclass
class Bucket:
    depth: int
    prefix: int
    items: Dict[int, int]  # ordered dict ≈ slot array (insertion order)


class SeqExtHash:
    """Sequential extendible hash table with the paper's exact rules:

    * Insert is an upsert; returns TRUE iff the key was absent.
    * Delete returns TRUE iff the key was present.
    * No update (not even Delete) executes on a full bucket: it splits the
      destination until non-full, then applies (ExecOnBucket/FAIL rule).
    * Splits are local; the directory doubles only when a new bucket's depth
      exceeds the current directory depth.
    """

    def __init__(self, dmax: int, bucket_size: int, initial_depth: int = 0,
                 hash_name: str = "fmix32"):
        self.dmax = dmax
        self.b = bucket_size
        self.hash = _HASHES[hash_name]
        self.depth = initial_depth
        nb = 1 << initial_depth
        self.buckets: List[Bucket] = [
            Bucket(initial_depth, p, {}) for p in range(nb)
        ]
        # physical directory at full capacity (mirrors the static-capacity
        # adaptation; logically only the top `depth` bits are meaningful,
        # and both views are kept consistent by construction)
        self.dir: List[int] = [
            e >> (dmax - initial_depth) for e in range(1 << dmax)
        ]
        self.split_count = 0

    # -- helpers -----------------------------------------------------------
    def _entry(self, key: int) -> int:
        return self.hash(key) >> (HASH_BITS - self.dmax)

    def _bucket_of(self, key: int) -> Bucket:
        return self.buckets[self.dir[self._entry(key)]]

    def _split(self, bid: int) -> None:
        old = self.buckets[bid]
        assert old.depth < self.dmax, "hash bits exhausted"
        d1 = old.depth + 1
        b0 = Bucket(d1, old.prefix * 2, {})
        b1 = Bucket(d1, old.prefix * 2 + 1, {})
        for k, v in old.items.items():
            bit = (self.hash(k) >> (HASH_BITS - d1)) & 1
            (b1 if bit else b0).items[k] = v
        i0 = len(self.buckets)
        self.buckets.append(b0)
        self.buckets.append(b1)
        start = old.prefix << (self.dmax - old.depth)
        half = 1 << (self.dmax - d1)
        for e in range(start, start + half):
            self.dir[e] = i0
        for e in range(start + half, start + 2 * half):
            self.dir[e] = i0 + 1
        self.depth = max(self.depth, d1)
        self.split_count += 1

    # -- operations ---------------------------------------------------------
    def lookup(self, key: int) -> Tuple[bool, int]:
        bkt = self._bucket_of(key)
        if key in bkt.items:
            return True, bkt.items[key]
        return False, -1

    def insert(self, key: int, value: int) -> int:
        while True:
            bid = self.dir[self._entry(key)]
            bkt = self.buckets[bid]
            if len(bkt.items) < self.b:
                existed = key in bkt.items
                bkt.items[key] = value
                return FALSE if existed else TRUE
            if bkt.depth >= self.dmax:
                return OVERFLOW
            self._split(bid)

    def delete(self, key: int) -> int:
        while True:
            bid = self.dir[self._entry(key)]
            bkt = self.buckets[bid]
            if len(bkt.items) < self.b:
                if key in bkt.items:
                    del bkt.items[key]
                    return TRUE
                return FALSE
            if bkt.depth >= self.dmax:
                return OVERFLOW
            self._split(bid)

    def merge(self, parent_prefix: int, parent_depth: int) -> bool:
        """Merge the two buddies of `parent` if both non-full & fit."""
        d1 = parent_depth + 1
        if d1 > self.dmax:
            return False
        shift = self.dmax - d1
        e0 = (parent_prefix * 2) << shift
        e1 = (parent_prefix * 2 + 1) << shift
        i0, i1 = self.dir[e0], self.dir[e1]
        b0, b1 = self.buckets[i0], self.buckets[i1]
        if i0 == i1 or b0.depth != d1 or b1.depth != d1:
            return False
        if len(b0.items) >= self.b or len(b1.items) >= self.b:
            return False
        if len(b0.items) + len(b1.items) > self.b:
            return False
        merged = Bucket(parent_depth, parent_prefix, {})
        merged.items.update(b0.items)
        merged.items.update(b1.items)
        mid = len(self.buckets)
        self.buckets.append(merged)
        start = parent_prefix << (self.dmax - parent_depth)
        for e in range(start, start + (1 << (self.dmax - parent_depth))):
            self.dir[e] = mid
        self.depth = max(
            b.depth for i, b in enumerate(self.buckets) if i in set(self.dir)
        )
        return True

    # -- views ---------------------------------------------------------------
    def as_dict(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for bid in set(self.dir):
            out.update(self.buckets[bid].items)
        return out

    def layout(self) -> Dict[int, Tuple[int, int, frozenset]]:
        """entry → (bucket depth, prefix, item set); for structural equality."""
        out = {}
        for e, bid in enumerate(self.dir):
            b = self.buckets[bid]
            out[e] = (b.depth, b.prefix, frozenset(b.items.items()))
        return out


# ---------------------------------------------------------------------------
# streaming oracle: statuses + content without materializing a directory


_D_MASK = (1 << 64) - 1
_D_C0 = 0x9E3779B97F4A7C15
_D_C1 = 0xBF58476D1CE4E5B9
_D_C2 = 0x94D049BB133111EB


def pair_digest(key: int, value: int) -> int:
    """splitmix64 finalizer of the packed (key, value) pair — one term of
    the rolling multiset content digest (summed mod 2**64)."""
    z = (((key & 0xFFFFFFFF) << 32) | (value & 0xFFFFFFFF))
    z = (z + _D_C0) & _D_MASK
    z = ((z ^ (z >> 30)) * _D_C1) & _D_MASK
    z = ((z ^ (z >> 27)) * _D_C2) & _D_MASK
    return (z ^ (z >> 31)) & _D_MASK


def _vpair_digest(keys, values):
    """Vectorized :func:`pair_digest`: one uint64 term per (key, value)."""
    k = (np.asarray(keys).astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
    v = (np.asarray(values).astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
    z = (k << np.uint64(32)) | v
    z = z + np.uint64(_D_C0)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_D_C1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_D_C2)
    return z ^ (z >> np.uint64(31))


def content_digest(keys, values) -> int:
    """Vectorized multiset digest of a (keys, values) item array: the sum
    of :func:`pair_digest` over all pairs, mod 2**64. Order-independent by
    construction, so the digest of a table image (any placement, any
    layout history) equals the digest a :class:`StreamingOracle` kept
    incrementally — the O(n)-vs-O(1)-state final-content parity check."""
    keys = np.asarray(keys)
    if keys.size == 0:
        return 0
    return int(_vpair_digest(keys, values).sum(dtype=np.uint64))


def _vfmix32(keys):
    """Vectorized :func:`_fmix32` over an int key array -> uint32 hashes."""
    k = (np.asarray(keys).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    k = k ^ (k >> np.uint32(16))
    k = k * np.uint32(0x85EBCA6B)
    k = k ^ (k >> np.uint32(13))
    k = k * np.uint32(0xC2B2AE35)
    return k ^ (k >> np.uint32(16))


def _videntity(keys):
    return (np.asarray(keys).astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)


_VHASHES = {"fmix32": _vfmix32, "identity": _videntity}


class StreamingOracle:
    """Bounded-memory sequential oracle: same statuses, no directory.

    **Why this is exact** (not an approximation): in :class:`SeqExtHash`
    an update walks ``dir -> bucket``, splits while the destination is
    full, and OVERFLOWs only from a full bucket already at depth ``dmax``.
    A bucket at depth ``dmax`` holds *exactly* the live keys sharing all
    top ``dmax`` hash bits (its group), so:

    * insert/delete return OVERFLOW **iff** the op key's group has
      ``>= bucket_size`` live members — splitting can never thin a
      same-group bucket, and any fuller shallower bucket splits down to
      depth ``dmax`` without failing;
    * otherwise insert returns FALSE if the key is live (upsert) else
      TRUE, and delete returns TRUE if live else FALSE — exactly the
      presence rules, which depend only on content.

    Statuses are therefore a pure function of (live content, dmax,
    bucket_size, hash) — independent of the split/merge history — and the
    oracle needs only: the live ``{key: value}`` map, a ``{prefix: count}``
    group counter at ``dmax`` bits, and a rolling order-independent
    content digest (:func:`pair_digest` terms summed mod 2**64). Every op
    is O(1); memory is O(live items); content parity against a device
    table is one :func:`content_digest` over its canonical image.

    For a sharded table pass the *aggregate* bits (``dmax + shard_bits``)
    as ``dmax``.
    """

    def __init__(self, dmax: int, bucket_size: int,
                 hash_name: str = "fmix32"):
        assert 0 < dmax <= HASH_BITS, dmax
        self.dmax = dmax
        self.b = bucket_size
        self.hash = _HASHES[hash_name]
        self._vhash = _VHASHES[hash_name]
        self.items: Dict[int, int] = {}
        self.groups: Dict[int, int] = {}
        self._digest = 0
        self._dirty = False

    def _prefix(self, key: int) -> int:
        return self.hash(key) >> (HASH_BITS - self.dmax)

    @property
    def size(self) -> int:
        return len(self.items)

    def lookup(self, key: int) -> Tuple[bool, int]:
        if key in self.items:
            return True, self.items[key]
        return False, -1

    @property
    def digest(self) -> int:
        """Multiset content digest of the live set (mod 2**64).

        Maintained lazily: mutations only mark the cached value stale,
        and a read re-derives it with one vectorized
        :func:`content_digest` pass over the live items. The harness
        reads the digest per *event* (and once at the end) while
        mutating per *op*, so the amortized cost is negligible and the
        mutation hot path carries no finalizer arithmetic at all."""
        if self._dirty:
            n = len(self.items)
            keys = np.fromiter(self.items.keys(), dtype=np.int64, count=n)
            vals = np.fromiter(self.items.values(), dtype=np.int64, count=n)
            self._digest = content_digest(keys, vals)
            self._dirty = False
        return self._digest

    def insert(self, key: int, value: int) -> int:
        p = self._prefix(key)
        g = self.groups.get(p, 0)
        if g >= self.b:
            return OVERFLOW
        self._dirty = True
        if key in self.items:
            self.items[key] = value
            return FALSE
        self.items[key] = value
        self.groups[p] = g + 1
        return TRUE

    def delete(self, key: int) -> int:
        p = self._prefix(key)
        g = self.groups.get(p, 0)
        if g >= self.b:
            return OVERFLOW
        if key in self.items:
            del self.items[key]
            self._dirty = True
            if g == 1:
                del self.groups[p]
            else:
                self.groups[p] = g - 1
            return TRUE
        return FALSE

    def run_ops(self, kinds, keys, values=None):
        """Batched op application: the bulk-validation fast path.

        ``kinds``/``keys``/``values`` are equal-length int arrays with the
        table's op encoding (0=NOP, 1=INSERT, 2=DELETE); returns the
        status array (int64). Semantically identical to calling
        :meth:`insert`/:meth:`delete` per lane in order — the hashing is
        precomputed vectorized and the sequential residue is bound-local
        dict work (digest maintenance is deferred to the lazy
        :attr:`digest` read), which is what unlocks million-op traces."""
        kinds = np.asarray(kinds)
        keys = np.asarray(keys)
        if values is None:
            values = np.zeros_like(keys)
        shift = np.uint32(HASH_BITS - self.dmax)
        prefixes = (self._vhash(keys) >> shift).tolist()
        items, groups = self.items, self.groups
        groups_get = groups.get
        b = self.b
        out: List[int] = []
        append = out.append
        for kind, key, val, p in zip(
                kinds.tolist(), keys.tolist(), values.tolist(), prefixes):
            if kind == 0:
                append(FALSE)
                continue
            g = groups_get(p, 0)
            if g >= b:
                append(OVERFLOW)
                continue
            if kind == 1:
                if key in items:
                    items[key] = val
                    append(FALSE)
                else:
                    items[key] = val
                    groups[p] = g + 1
                    append(TRUE)
            elif key in items:
                del items[key]
                if g == 1:
                    del groups[p]
                else:
                    groups[p] = g - 1
                append(TRUE)
            else:
                append(FALSE)
        self._dirty = True
        return np.asarray(out, dtype=np.int64)

    def lookup_batch(self, keys):
        """Batched :meth:`lookup`: ``(found bool array, values int64
        array)`` with -1 where absent (the facade's raw-value contract)."""
        got = list(map(self.items.get, np.asarray(keys).tolist()))
        found = np.asarray([v is not None for v in got], dtype=bool)
        vals = np.asarray([-1 if v is None else v for v in got],
                          dtype=np.int64)
        return found, vals

    def as_dict(self) -> Dict[int, int]:
        return dict(self.items)
