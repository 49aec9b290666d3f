"""The paper's comparison algorithms (§6.1), batched, in torch.

The paper evaluates WF-Ext against three algorithms; ``repro/core/baselines.py``
models them in JAX and this module is its counterpart, in plain PyTorch on
one device (no kernel of its own: the JAX version reaches no Pallas
kernel either):

* **LF-Split** — Shalev & Shavit's split-ordered list: one sorted linked
  list holds all items; directory entries point at sentinel nodes. Lookups
  and updates walk the list; a batch of updates models CAS contention as
  conflict-retry rounds.
* **LF-Freeze-M** — Liu et al.'s freeze-based array table with fixed
  buckets: every update replaces its whole bucket (copy-on-write, no
  combining), one winner per directory entry and round.
* **Lock** — per-bucket lock, non-resizable: every operation, lookups
  included, runs as one step of a strict sequential fold over the lanes
  (the worst legal schedule).

Names, config fields, defaults and status codes are the JAX package's:
1 fresh insert or delete hit, 0 upsert or delete miss, -1 idle lane, and
LF-Freeze's -3 (bucket full or frozen: needs a resize this variant does
not do). ``*_init(cfg, device=None)`` builds on the card unless the caller
names another device (``core/table.py::resolve_device``). Updates write
the state's tensors in place and return the state: the state passed in is
consumed. The retry rounds are Python loops that read one device flag per
round, as ``core/table.py::apply_batch`` does.

Where the port differs from the JAX package, on purpose:

* **LF-Split's split-order key** is an int64 ``(h << 1) | 1`` for an item
  and ``b << (33 - depth)`` for bucket ``b``'s sentinel. The directory
  routes by the top bits of ``h``, so each bucket's items sort directly
  after its sentinel and a walk crosses only its own bucket; no two keys
  share a split-order key (both hashes are bijective). The JAX package
  bit-reverses both keys, which puts every sentinel before every item:
  walks grow with the whole list and are cut at ``max_walk``, and
  ``rev32(h) | 1`` maps ``h`` and ``h ^ 1`` to one key.
* **LF-Split's conflicts.** Every pending lane claims its predecessor; a
  delete that finds its key also claims that node. A lane wins a round
  only if no lower pending lane claims a node it claims; losers walk
  again next round. The rule compares every pair of lanes' claims, so
  LF-Split takes at most ``SPLIT_MAX_LANES`` (512) lanes. The JAX package
  lets one lane win per predecessor only, so deletes of two adjacent nodes, or a delete of X and an insert
  after X, both win and one is lost. A walk cut at ``max_walk`` leaves its
  lane pending (the error flag is set when the rounds run out), instead of
  splicing at the wrong place.
* **LF-Split's node arrays** have one more node, ``max_nodes``: the list's
  tail (its split-order key is above every key, so walks stop there
  without a bounds test) and the target of the writes of lanes that write
  nothing, reset after each round. A node index is int64.
* **A lookup never matches ``EMPTY_KEY``**, in all three structures (the
  JAX LF-Freeze and Lock lookups match it to a free slot).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.hashing import EMPTY_KEY, HASH_FNS, dir_index
from repro_torch.core.table import _first_true, probe_rows, resolve_device

I32 = torch.int32
I64 = torch.int64

# LF-Split finds a round's winners by an [n, 2, n, 2] comparison of the
# lanes' claims, which bounds its width
SPLIT_MAX_LANES = 512
# walk steps between two host reads of "is any lane still walking"
WALK_BLOCK = 8


def _lanes(n: int, device, *xs):
    """Op-batch inputs as 1-d tensors of ``n`` lanes on ``device``."""
    out = [torch.as_tensor(x, device=device) for x in xs]
    for x in out:
        if x.shape != (n,):
            raise ValueError(f"op batch has shape {tuple(x.shape)}, config "
                             f"has n_lanes={n}")
    return out


def _winners_of_first(key, pending, n_keys: int):
    """One winner per key among the pending lanes: the lowest lane (the
    stable-sort rule of the JAX package's CAS model)."""
    k = torch.where(pending, key, n_keys)
    order = torch.sort(k, stable=True).indices
    sk = k[order]
    first = torch.ones_like(pending)
    first[1:] = sk[1:] != sk[:-1]
    winner = torch.empty_like(pending)
    winner[order] = first
    return winner & pending


# -----------------------------------------------------------------------------
# LF-Split: split-ordered list
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    depth: int = 6            # directory depth (2**depth sentinel buckets)
    max_nodes: int = 4096     # node pool (items + sentinels)
    n_lanes: int = 16
    hash_name: str = "fmix32"
    max_walk: int = 512       # bounded pointer chase (≥ max items per bucket)
    max_retry: int = 8        # batched CAS-conflict retry rounds (x4)

    def __post_init__(self):
        if self.n_lanes > SPLIT_MAX_LANES:
            raise ValueError(f"LF-Split takes at most {SPLIT_MAX_LANES} "
                             f"lanes, got n_lanes={self.n_lanes}")

    @property
    def hash_fn(self):
        return HASH_FNS[self.hash_name]

    @property
    def nbuckets(self) -> int:
        return 1 << self.depth


class SplitState(NamedTuple):
    sokey: torch.Tensor    # i64[N+1] split-order key (sentinels even, items odd)
    key: torch.Tensor      # i32[N+1] original key (EMPTY_KEY for sentinels)
    val: torch.Tensor      # i32[N+1]
    nxt: torch.Tensor      # i64[N+1] next node (N = the tail)
    buckets: torch.Tensor  # i64[2**depth] sentinel node per bucket
    nalloc: torch.Tensor   # i32[]
    error: torch.Tensor    # bool[]


# above every split-order key (those are below 2**33)
_TAIL_SOKEY = 1 << 62


def _reset_tail(cfg: SplitConfig, st: SplitState) -> None:
    t = cfg.max_nodes
    st.sokey[t] = _TAIL_SOKEY
    st.key[t] = EMPTY_KEY
    st.val[t] = 0
    st.nxt[t] = t


def split_init(cfg: SplitConfig, device=None) -> SplitState:
    """Link all sentinels eagerly, in split order (the lazy parent-chain
    init of the original is an artifact of dynamic growth)."""
    dev = resolve_device(device)
    nb, n = cfg.nbuckets, cfg.max_nodes
    if n < nb:
        raise ValueError(f"max_nodes={n} < {nb} sentinels")
    so = torch.arange(nb, dtype=I64, device=dev) << (33 - cfg.depth)
    order = torch.argsort(so)        # already ascending: kept as the rule
    nxt = torch.full((n + 1,), n, dtype=I64, device=dev)
    nxt[order[:-1]] = order[1:]
    sokey = torch.zeros(n + 1, dtype=I64, device=dev)
    sokey[:nb] = so
    st = SplitState(
        sokey=sokey,
        key=torch.full((n + 1,), EMPTY_KEY, dtype=I32, device=dev),
        val=torch.zeros(n + 1, dtype=I32, device=dev),
        nxt=nxt,
        buckets=torch.arange(nb, dtype=I64, device=dev),
        nalloc=torch.tensor(nb, dtype=I32, device=dev),
        error=torch.tensor(False, device=dev))
    _reset_tail(cfg, st)
    return st


def _split_route(cfg: SplitConfig, st: SplitState, keys):
    """(sentinel to walk from, split-order key) of each key."""
    h = cfg.hash_fn(keys)
    return st.buckets[dir_index(h, cfg.depth)], (h << 1) | 1


def _walk(cfg: SplitConfig, st: SplitState, start, target):
    """Chase pointers until ``sokey[curr] >= target``, at most
    ``max_walk`` steps. Returns (pred, curr, cut): ``cut`` marks the lanes
    still walking at the bound. All lanes advance masked, ``WALK_BLOCK``
    steps between two host reads; a finished lane does not move, so each
    lane ends where a per-lane loop would."""
    pred = start
    curr = st.nxt[start]
    steps = 0
    while True:
        for _ in range(min(WALK_BLOCK, cfg.max_walk - steps)):
            adv = st.sokey[curr] < target
            pred = torch.where(adv, curr, pred)
            curr = torch.where(adv, st.nxt[curr], curr)
        steps = min(steps + WALK_BLOCK, cfg.max_walk)
        active = st.sokey[curr] < target
        if steps >= cfg.max_walk or not bool(active.any()):
            return pred, curr, active


def split_lookup(cfg: SplitConfig, st: SplitState, queries):
    """(found bool[m], value i32[m], -1 where absent)."""
    queries = torch.as_tensor(queries, dtype=I32, device=st.key.device)
    start, so = _split_route(cfg, st, queries)
    _, curr, _ = _walk(cfg, st, start, so)
    hit = ((st.sokey[curr] == so) & (st.key[curr] == queries)
           & (queries != EMPTY_KEY))
    return hit, torch.where(hit, st.val[curr], -1)


def _split_winners(pending, pred, second):
    """Lanes that win a round: no lower pending lane claims a node they
    claim. Each lane claims ``pred`` and, where ``second >= 0``, the node
    ``second``; non-pending lanes claim nothing."""
    n = pending.shape[0]
    lane = torch.arange(n, device=pending.device)
    second = torch.where(second >= 0, second, -1 - lane)   # unique, unclaimed
    claims = torch.stack([pred, second], 1)                # [n, 2]
    same = (claims[:, :, None, None] == claims[None, None]).any(3).any(1)
    lower = torch.ones(n, n, dtype=torch.bool,
                       device=pending.device).tril(-1)
    lost = (same & lower & pending[None, :]).any(1)
    return pending & ~lost


def split_update(cfg: SplitConfig, st: SplitState, kinds, keys, values):
    """Batched insert (= upsert) / delete with CAS-conflict retry rounds.

    Round: every pending op walks to its splice point in parallel; the
    winners (``_split_winners``) apply, the others walk again next round.
    kinds: 1 = insert, 2 = delete, 0 = idle. Returns (state, status i8)."""
    n, N = cfg.n_lanes, cfg.max_nodes
    kinds, keys, values = _lanes(n, st.key.device, kinds, keys, values)
    keys, values = keys.to(I32), values.to(I32)
    start, so = _split_route(cfg, st, keys)
    ins, dele = kinds == 1, kinds == 2
    pending = kinds != 0
    status = torch.full((n,), -1, dtype=torch.int8, device=keys.device)
    tail = torch.full_like(start, N)
    for _ in range(cfg.max_retry * 4):
        if not bool(pending.any()):
            break
        pred, curr, cut = _walk(cfg, st, start, so)
        exist = (st.sokey[curr] == so) & (st.key[curr] == keys)
        live = pending & ~cut
        winner = _split_winners(live, pred, torch.where(dele & exist, curr,
                                                        -1))
        upd = winner & ins & exist
        new = winner & ins & ~exist
        dhit = winner & dele & exist
        dmiss = winner & dele & ~exist
        nid = st.nalloc + torch.cumsum(new, 0) - 1
        fits = new & (nid < N)
        error = st.error | (st.nalloc + new.sum() > N)
        succ = st.nxt[curr]                  # read before the links change
        node = torch.where(fits, nid, tail)
        st.sokey.index_put_((node,), so)
        st.key.index_put_((node,), keys)
        st.val.index_put_((torch.cat([node, torch.where(upd, curr, tail)]),),
                          torch.cat([values, values]))
        # a new node points at curr; its predecessor, or a deleted node's,
        # at the new node or at the deleted node's successor
        st.nxt.index_put_(
            (torch.cat([node, torch.where(fits | dhit, pred, tail)]),),
            torch.cat([curr, torch.where(fits, nid, succ)]))
        _reset_tail(cfg, st)
        st = st._replace(nalloc=(st.nalloc + fits.sum()).to(I32),
                         error=error)
        status = torch.where(upd | dmiss, 0, status)
        status = torch.where(fits | dhit, 1, status).to(torch.int8)
        pending = pending & ~(upd | fits | dhit | dmiss)
    return st._replace(error=st.error | pending.any()), status


# -----------------------------------------------------------------------------
# LF-Freeze-M: freeze-based array-bucket table (fixed buckets)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FreezeConfig:
    depth: int = 6            # static directory depth
    bucket_size: int = 8
    pool_size: int = 512      # bucket-version pool
    n_lanes: int = 16
    hash_name: str = "fmix32"
    max_retry: int = 16

    @property
    def hash_fn(self):
        return HASH_FNS[self.hash_name]

    @property
    def nbuckets(self) -> int:
        return 1 << self.depth


class FreezeState(NamedTuple):
    directory: torch.Tensor   # i32[2**depth] → pool row (current version)
    keys: torch.Tensor        # i32[P+1, B] (row P: write trash)
    vals: torch.Tensor        # i32[P+1, B]
    frozen: torch.Tensor      # bool[P+1]
    nalloc: torch.Tensor      # i32[]
    free_stack: torch.Tensor  # i32[P+1] retired versions (epoch-GC analogue)
    free_top: torch.Tensor    # i32[]
    error: torch.Tensor       # bool[]


def freeze_init(cfg: FreezeConfig, device=None) -> FreezeState:
    dev = resolve_device(device)
    P, B, nb = cfg.pool_size, cfg.bucket_size, cfg.nbuckets
    if P <= nb:
        raise ValueError(f"pool_size={P} must exceed {nb} buckets")
    return FreezeState(
        directory=torch.arange(nb, dtype=I32, device=dev),
        keys=torch.full((P + 1, B), EMPTY_KEY, dtype=I32, device=dev),
        vals=torch.zeros((P + 1, B), dtype=I32, device=dev),
        frozen=torch.zeros(P + 1, dtype=torch.bool, device=dev),
        nalloc=torch.tensor(nb, dtype=I32, device=dev),
        free_stack=torch.zeros(P + 1, dtype=I32, device=dev),
        free_top=torch.tensor(0, dtype=I32, device=dev),
        error=torch.tensor(False, device=dev))


def freeze_lookup(cfg: FreezeConfig, st: FreezeState, queries):
    """(found bool[m], value i32[m], -1 where absent)."""
    queries = torch.as_tensor(queries, dtype=I32, device=st.keys.device)
    row = st.directory[dir_index(cfg.hash_fn(queries), cfg.depth)]
    return probe_rows(row, queries, st.keys, st.vals)


def freeze_update(cfg: FreezeConfig, st: FreezeState, kinds, keys, values):
    """Every update allocates a fresh bucket version (a full copy) and
    swaps the directory pointer: no combining, so same-bucket updates get
    one winner per round (CAS retry), and every update pays a bucket-sized
    copy and an allocation. Returns (state, status i8)."""
    n, P, B, nb = cfg.n_lanes, cfg.pool_size, cfg.bucket_size, cfg.nbuckets
    kinds, keys, values = _lanes(n, st.keys.device, kinds, keys, values)
    keys, values = keys.to(I32), values.to(I32)
    e = dir_index(cfg.hash_fn(keys), cfg.depth)
    ins = kinds == 1
    slots = torch.arange(B, device=keys.device)
    pending = kinds != 0
    status = torch.full((n,), -1, dtype=torch.int8, device=keys.device)
    for _ in range(cfg.max_retry):
        if not bool(pending.any()):
            break
        row = st.directory[e].long()
        # one winner per directory entry (CAS on the bucket pointer)
        winner = _winners_of_first(e, pending, nb)
        rows_k, rows_v = st.keys[row], st.vals[row]
        occ = rows_k != EMPTY_KEY
        frozen = st.frozen[row]
        eq = rows_k == keys[:, None]
        exist = eq.any(-1)
        full = (occ.sum(-1) == B) & ~exist
        can = winner & ~frozen & ~(ins & full)
        # the new version: a copy with the op's slot rewritten
        slot = torch.where(ins & ~exist, _first_true(~occ), _first_true(eq))
        hit = (slots == slot[:, None]) & (can & (ins | exist))[:, None]
        new_k = torch.where(hit, torch.where(ins, keys, EMPTY_KEY)[:, None],
                            rows_k)
        new_v = torch.where(hit, values[:, None], rows_v)
        # fresh version rows, from the free stack first
        rank = torch.cumsum(can, 0) - 1
        ncan = can.sum()
        from_stack = rank < st.free_top
        sidx = (st.free_top - 1 - rank).clamp(0, P)
        nid = torch.where(from_stack, st.free_stack[sidx],
                          st.nalloc + rank - st.free_top)
        nid = torch.where(can, nid, P).clamp(0, P)
        kpop = torch.minimum(ncan, st.free_top)
        grow = ncan - kpop
        error = st.error | (st.nalloc + grow > P)
        # lanes that write nothing write the trash row P (entry P of the
        # free stack, a padding entry of the directory), reset afterwards
        st.keys.index_put_((nid,), new_k)
        st.vals.index_put_((nid,), new_v)
        st.keys[P] = EMPTY_KEY
        st.vals[P] = 0
        dpad = torch.cat([st.directory, st.directory[:1]])
        dpad.index_put_((torch.where(can, e, nb),), nid.to(I32))
        push = torch.where(can, st.free_top - kpop + rank, P).clamp(0, P)
        st.free_stack.index_put_((push,), row.to(I32))
        st.free_stack[P] = 0
        st = st._replace(directory=dpad[:nb],
                         nalloc=(st.nalloc + grow).to(I32),
                         free_top=(st.free_top - kpop + ncan).to(I32),
                         error=error)
        status = torch.where(can, torch.where(ins, ~exist, exist).to(
            torch.int8), status)
        blocked = winner & (frozen | (ins & full))
        status = torch.where(blocked, -3, status).to(torch.int8)
        pending = pending & ~(can | blocked)
    return st._replace(error=st.error | pending.any()), status


# -----------------------------------------------------------------------------
# Lock: per-bucket lock, non-resizable; lookups serialize too (rule A broken)
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockConfig:
    depth: int = 6
    bucket_size: int = 8
    n_lanes: int = 16
    hash_name: str = "fmix32"

    @property
    def hash_fn(self):
        return HASH_FNS[self.hash_name]

    @property
    def nbuckets(self) -> int:
        return 1 << self.depth


class LockState(NamedTuple):
    keys: torch.Tensor   # i32[NB, B]
    vals: torch.Tensor   # i32[NB, B]
    error: torch.Tensor  # bool[]


def lock_init(cfg: LockConfig, device=None) -> LockState:
    dev = resolve_device(device)
    shape = (cfg.nbuckets, cfg.bucket_size)
    return LockState(
        keys=torch.full(shape, EMPTY_KEY, dtype=I32, device=dev),
        vals=torch.zeros(shape, dtype=I32, device=dev),
        error=torch.tensor(False, device=dev))


def lock_step(cfg: LockConfig, st: LockState, kinds, keys, values):
    """All ops, lookups (kind 3) included, serialize through their
    bucket's lock: a strict sequential fold over the lanes, ``n_lanes``
    dependent steps with no host read. Returns (state, status i8,
    value i32 of each lookup hit, -1 elsewhere).

    Each step finds ``m``, the least of ``j`` over the row's slots ``j``
    holding the key and of ``B + j`` over its free slots (``2B`` if
    neither): the key is there iff ``m < B``, else the insert slot is
    ``m - B``. The lane's write target and lookup source are then read from
    per-lane tables indexed by ``m``; a lane that writes nothing writes the
    trash row of the fold's padded copy of the state."""
    n, B, nb = cfg.n_lanes, cfg.bucket_size, cfg.nbuckets
    dev = st.keys.device
    kinds, keys, values = _lanes(n, dev, kinds, keys, values)
    keys, values = keys.to(I32), values.to(I32)
    b = dir_index(cfg.hash_fn(keys), cfg.depth)
    ins, dele, lkp = kinds == 1, kinds == 2, kinds == 3
    kp = torch.cat([st.keys, st.keys[:1]])
    vp = torch.cat([st.vals, st.vals[:1]])
    kflat, vflat = kp.view(-1), vp.view(-1)
    trash = nb * B
    # the compared keys of each lane: its key (never matched for a lookup
    # of EMPTY_KEY) and EMPTY_KEY (a free slot)
    own = torch.where(lkp & (keys == EMPTY_KEY), 1 << 40, keys.to(I64))
    query = torch.stack([own, torch.full_like(own, EMPTY_KEY)], 1)[:, :, None]
    code = torch.arange(2 * B, device=dev).view(2, B)
    none = torch.full_like(code, 2 * B)
    m_all = torch.arange(2 * B + 1, device=dev)
    flat = b[:, None] * B + m_all % B
    limit = torch.where(ins, 2 * B, torch.where(dele, B, 0))
    tables = torch.stack([torch.where(m_all < limit[:, None], flat, trash),
                          torch.where(m_all < B, flat, trash)], 1)
    new_k = torch.where(ins, keys, EMPTY_KEY)
    new_v = torch.where(ins, values, 0)
    m = torch.empty(n, dtype=I64, device=dev)
    seen = torch.empty(n, dtype=I32, device=dev)
    for bi, q, tab, mi, nk, nv, vi in zip(
            b.split(1), query.unbind(0), tables.unbind(0), m.split(1),
            new_k.split(1), new_v.split(1), seen.split(1)):
        row = kp.index_select(0, bi)
        torch.amin(torch.where(row == q, code, none).view(-1), 0,
                   keepdim=True, out=mi)
        w, r = tab.index_select(1, mi)
        kflat.index_copy_(0, w, nk)
        vflat.index_copy_(0, w, nv)
        torch.index_select(vflat, 0, r, out=vi)
    exist = m < B
    status = torch.where(ins, ~exist, (dele | lkp) & exist).to(torch.int8)
    vout = torch.where(lkp & exist, seen, -1)
    error = st.error | (ins & (m == 2 * B)).any()
    return LockState(kp[:nb], vp[:nb], error), status, vout


__all__ = ["SplitConfig", "SplitState", "split_init", "split_lookup",
           "split_update", "FreezeConfig", "FreezeState", "freeze_init",
           "freeze_lookup", "freeze_update", "LockConfig", "LockState",
           "lock_init", "lock_step"]
