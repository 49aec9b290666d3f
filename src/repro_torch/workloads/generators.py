"""Deterministic seeded workload generators (keys, mixes, live-set model).

A copy of the JAX package's ``repro/workloads/generators.py``: the same
seeds give the same op streams in both packages. The generator side of the
churn engine is plain host-side numpy: it has to feed *both* the table and
the sequential reference oracle with exactly the same operation stream, so nothing here may depend on device state. All
randomness flows from one ``np.random.default_rng(seed)`` per trace —
identical seeds produce bit-identical op streams on every host.

Key distributions (YCSB-style)
------------------------------
Reads, updates and deletes target the *live* key set through a rank
sampler: ``uniform`` picks any live key, ``zipf`` skews toward the oldest
inserted keys with the classic ``1/rank**theta`` popularity law (YCSB's
scrambled-zipfian stand-in), ``latest`` skews toward the most recently
inserted keys (YCSB-D's read-latest). Inserts draw fresh keys from a
seeded permutation of the universe, so every insert is new until the
universe is exhausted (after which they degrade to upserts, never raising).

Op mixes
--------
:class:`OpMix` holds the per-op probabilities; :data:`YCSB_MIXES` provides
the standard letters (A: 50/50 read/update, B: 95/5, C: read-only,
D: read-latest with 5% inserts) plus the resize-heavy mixes the churn
scenarios use (``fill``, ``drain``, ``churn``, ``maintain``). ``noop``
lanes deliberately emit NOP operations: an all-NOP transaction still runs
the elastic resize policy, which is how drained tables keep merging while
traffic is read-only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np

OP_NAMES = ("read", "update", "insert", "delete", "noop")

# table op kinds (those of repro_torch.core.table)
NOP, INS, DEL = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class OpMix:
    """Per-step operation probabilities (must sum to 1)."""

    read: float = 0.0
    update: float = 0.0
    insert: float = 0.0
    delete: float = 0.0
    noop: float = 0.0

    def __post_init__(self):
        total = self.read + self.update + self.insert + self.delete + self.noop
        assert abs(total - 1.0) < 1e-9, f"op mix must sum to 1, got {total}"

    def probs(self) -> np.ndarray:
        return np.asarray(
            [self.read, self.update, self.insert, self.delete, self.noop]
        )


YCSB_MIXES: Dict[str, OpMix] = {
    # the four classic YCSB letters (E's scans do not exist in this API)
    "A": OpMix(read=0.5, update=0.5),
    "B": OpMix(read=0.95, update=0.05),
    "C": OpMix(read=1.0),
    "D": OpMix(read=0.95, insert=0.05),
    # resize-heavy phases for the churn engine
    "fill": OpMix(insert=1.0),
    "drain": OpMix(delete=0.9, read=0.1),
    "churn": OpMix(read=0.3, update=0.1, insert=0.3, delete=0.3),
    "maintain": OpMix(read=0.5, noop=0.5),
}


class LiveSet:
    """O(1) add/remove/sample host-side model of the table's live keys."""

    def __init__(self) -> None:
        self.keys: List[int] = []
        self._pos: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.keys)

    def __contains__(self, key: int) -> bool:
        return key in self._pos

    def add(self, key: int) -> None:
        if key not in self._pos:
            self._pos[key] = len(self.keys)
            self.keys.append(key)

    def remove(self, key: int) -> None:
        pos = self._pos.pop(key, None)
        if pos is None:
            return
        last = self.keys.pop()
        if pos < len(self.keys):
            self.keys[pos] = last
            self._pos[last] = pos


@functools.lru_cache(maxsize=4096)
def _zipf_weights(n: int, theta: float) -> np.ndarray:
    """Normalized 1/rank**theta weights, cached per (n, theta): the live-set
    size repeats across steps, and rebuilding the vector per sampled lane
    was the replay harness's dominant generator cost."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-theta)
    w /= w.sum()
    w.setflags(write=False)
    return w


def sample_ranks(
    rng: np.random.Generator, dist: str, theta: float, size: int, n_live: int
) -> np.ndarray:
    """Indices into the live list for one batch of read/update/delete ops.

    ``uniform`` is position-agnostic; ``zipf`` favors low ranks (oldest
    keys — stable hot set); ``latest`` favors high ranks (newest keys)."""
    assert n_live > 0
    if dist == "uniform":
        return rng.integers(0, n_live, size=size)
    if dist == "zipf":
        return rng.choice(n_live, size=size, p=_zipf_weights(n_live, theta))
    if dist == "latest":
        ranks = rng.choice(n_live, size=size, p=_zipf_weights(n_live, theta))
        return n_live - 1 - ranks
    raise ValueError(f"unknown key distribution {dist!r}")


@dataclasses.dataclass
class Step:
    """One generated workload step: a mutation batch plus a read batch."""

    phase: str
    kinds: np.ndarray  # i32[m] in {NOP, INS, DEL}
    keys: np.ndarray  # i32[m]
    vals: np.ndarray  # i32[m]
    reads: np.ndarray  # i32[r] lookup queries

    @property
    def n_mutations(self) -> int:
        return int((self.kinds != NOP).sum())


class StepGen:
    """Stateful generator: draws steps and mirrors their effect on the
    live-set model (so later steps can target keys earlier steps created).

    The mirror applies the mutation batch *in lane order* — the same
    linearization the combining transaction uses within a bucket — so a
    delete issued after an insert of the same key in one batch sees it."""

    def __init__(self, universe: int, seed: int) -> None:
        assert universe > 1
        self.rng = np.random.default_rng(seed)
        self.universe = universe
        # fresh-insert stream: a seeded permutation of [1, universe]
        self._fresh = self.rng.permutation(np.arange(1, universe + 1))
        self._cursor = 0
        self.live = LiveSet()
        self._val = 0

    def _fresh_key(self) -> int:
        while self._cursor < len(self._fresh):
            k = int(self._fresh[self._cursor])
            self._cursor += 1
            if k not in self.live:
                return k
        # universe exhausted: degrade to upserting a random universe key
        return int(self.rng.integers(1, self.universe + 1))

    def _next_val(self) -> int:
        self._val += 1
        return self._val

    def step(
        self,
        phase: str,
        mix: OpMix,
        batch: int,
        dist: str = "uniform",
        theta: float = 0.99,
        read_absent_frac: float = 0.1,
    ) -> Step:
        """Draw one step of ``batch`` op slots from ``mix``.

        Reads go to the lookup channel; everything else becomes one
        mutation batch. Reads/updates/deletes with an empty live set
        degrade to inserts (the stream never blocks)."""
        choices = self.rng.choice(len(OP_NAMES), size=batch, p=mix.probs())
        kinds: List[int] = []
        keys: List[int] = []
        vals: List[int] = []
        reads: List[int] = []
        for c in choices:
            op = OP_NAMES[c]
            if op in ("read", "update", "delete") and len(self.live) == 0:
                op = "insert" if op != "read" else "read_absent"
            if op == "read":
                if self.rng.random() < read_absent_frac:
                    op = "read_absent"
                else:
                    rank = sample_ranks(self.rng, dist, theta, 1, len(self.live))
                    reads.append(self.live.keys[int(rank[0])])
                    continue
            if op == "read_absent":
                # probe keys outside the universe: guaranteed misses
                lo, hi = self.universe + 1, 2 * self.universe + 1
                reads.append(int(self.rng.integers(lo, hi)))
                continue
            if op == "noop":
                kinds.append(NOP)
                keys.append(0)
                vals.append(0)
                continue
            if op == "insert":
                k = self._fresh_key()
                kinds.append(INS)
                keys.append(k)
                vals.append(self._next_val())
                self.live.add(k)
                continue
            rank = sample_ranks(self.rng, dist, theta, 1, len(self.live))
            k = self.live.keys[int(rank[0])]
            if op == "update":
                kinds.append(INS)
                keys.append(k)
                vals.append(self._next_val())
            else:  # delete
                kinds.append(DEL)
                keys.append(k)
                vals.append(0)
                self.live.remove(k)
        return Step(
            phase=phase,
            kinds=np.asarray(kinds, np.int32),
            keys=np.asarray(keys, np.int32),
            vals=np.asarray(vals, np.int32),
            reads=np.asarray(reads, np.int32),
        )
