"""Bounded per-shard admission queues for the request router.

The JAX package's ``repro/serving/router/queue.py``, plus
:meth:`ShardQueues.rehome`, which a handover calls to recount the queued
requests under the successor's shards. Requests are routed to the shard
that will own their key — the same top ``shard_bits`` of the hash the
sharded placement itself uses (local placement is one shard) — and each
shard's queue depth is bounded:
admission fails with ``SHED_QUEUE_FULL`` when the key's home shard is
backed up, so one hot shard sheds load instead of growing an unbounded
queue in front of everyone. Within the admitted set, reads and writes
live in separate FIFOs (writes can be *deferred* under resize pressure
while reads keep flowing); both preserve arrival order, which is the
linearization order the differential oracle replays.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, List, Optional

from repro_torch.core.reference import _HASHES, HASH_BITS

# request kinds: the core op kinds plus a read channel
NOP, INS, DEL = 0, 1, 2
READ = 3

# admission decisions
ADMITTED = "admitted"
SHED_QUEUE_FULL = "shed_queue_full"
SHED_PRESSURE = "shed_pressure"


@dataclasses.dataclass
class Request:
    """One client request with its latency stamps and eventual result.

    ``kind`` is READ / INS / DEL; ``status`` carries the transaction
    status for mutations (TRUE/FALSE/FROZEN/OVERFLOW as i8) and, for
    reads, ``found``/``result`` carry the rule-A lookup outcome."""

    rid: int
    kind: int
    key: int
    value: int = 0
    shard: int = 0
    t_submit: float = math.nan
    t_dispatch: float = math.nan
    t_complete: float = math.nan
    status: Optional[int] = None
    found: Optional[bool] = None
    result: Optional[int] = None

    @property
    def is_write(self) -> bool:
        return self.kind != READ


def shard_of(key: int, spec) -> int:
    """The key's home shard: top ``shard_bits`` of the spec's hash — the
    exact routing the sharded placement applies on-device (0 for local
    placement)."""
    if spec.placement != "sharded":
        return 0
    h = _HASHES[spec.hash_name](int(key))
    return h >> (HASH_BITS - spec.shard_bits)


class ShardQueues:
    """Arrival-ordered read/write FIFOs with per-shard depth bounds.

    ``admit`` enforces the bound at the key's home shard; ``take_reads``
    / ``take_writes`` pop in global arrival order (FIFO across shards —
    fair, and the order the oracle replays). Depth accounting spans both
    queues: a shard's bound covers all of its queued work."""

    def __init__(self, n_shards: int, max_depth_per_shard: int):
        if n_shards < 1 or max_depth_per_shard < 1:
            raise ValueError(f"need n_shards >= 1 and max_depth_per_shard "
                             f">= 1, got {n_shards}, {max_depth_per_shard}")
        self.n_shards = n_shards
        self.max_depth = max_depth_per_shard
        self._reads: Deque[Request] = deque()
        self._writes: Deque[Request] = deque()
        self._depth = [0] * n_shards

    # -- depth accounting --------------------------------------------------

    def __len__(self) -> int:
        return len(self._reads) + len(self._writes)

    @property
    def n_reads(self) -> int:
        return len(self._reads)

    @property
    def n_writes(self) -> int:
        return len(self._writes)

    def depth(self, shard: int) -> int:
        return self._depth[shard]

    def depths(self) -> List[int]:
        return list(self._depth)

    def oldest_wait(self, now: float) -> float:
        """Age of the oldest queued request (0 when empty)."""
        heads = [q[0].t_submit for q in (self._reads, self._writes) if q]
        return (now - min(heads)) if heads else 0.0

    def oldest_write_wait(self, now: float) -> float:
        return (now - self._writes[0].t_submit) if self._writes else 0.0

    # -- admit / take ------------------------------------------------------

    def admit(self, req: Request) -> bool:
        """Enqueue unless the request's home shard is at its bound."""
        if self._depth[req.shard] >= self.max_depth:
            return False
        (self._writes if req.is_write else self._reads).append(req)
        self._depth[req.shard] += 1
        return True

    def _take(self, q: Deque[Request], k: int) -> List[Request]:
        out: List[Request] = []
        while q and len(out) < k:
            req = q.popleft()
            self._depth[req.shard] -= 1
            out.append(req)
        return out

    def take_reads(self, k: int) -> List[Request]:
        return self._take(self._reads, k)

    def take_writes(self, k: int) -> List[Request]:
        return self._take(self._writes, k)

    # -- re-homing ---------------------------------------------------------

    def rehome(self, spec) -> None:
        """Re-home every queued request under ``spec`` (a handover's
        successor): one depth counter per successor shard, each request's
        ``shard`` recomputed from its key, both FIFOs kept in order. A
        shard may come out above its bound; admission then sheds there
        until it drains. (The JAX package keeps the predecessor's counters
        and shard indices across a handover, and indexes past them after a
        local -> sharded one.)"""
        self.n_shards = spec.n_shards
        self._depth = [0] * self.n_shards
        for q in (self._reads, self._writes):
            for req in q:
                req.shard = shard_of(req.key, spec)
                self._depth[req.shard] += 1


__all__ = [
    "Request", "ShardQueues", "shard_of",
    "NOP", "INS", "DEL", "READ",
    "ADMITTED", "SHED_QUEUE_FULL", "SHED_PRESSURE",
]
