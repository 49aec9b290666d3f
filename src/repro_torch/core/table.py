"""WF-Ext: the paper's wait-free resizable extendible hash table, in torch.

The shared-memory algorithm (announce in ``help[]`` → PSim combining → CAS
install) runs as a **batched combining transaction**: a batch of n lanes
plays the role of the n announced threads, and one ``apply_batch`` call is
the combiner that applies every announced operation and installs the new
state. The design rules are those of the JAX package:

  rule (A)  lookups are pure gathers on the current state — zero sync;
  rule (B)  ops on distinct buckets never interact (grouped combining);
  rule (C)  the common (no-resize) case is a single fused pass (segmented
               presence chains and occupancy prefix sums, then two
               sequenced scatters); the serial wave loop only runs for
               bucket groups that overflow;
  wait-freedom  at most ``cfg.rounds`` combining rounds, no retries;
  exactly-once  per-lane sequence numbers gate application;
  resize rules  full buckets are immutable (no update — not even Delete —
               runs on a full bucket); splits re-route and re-execute the
               pending ops that forced them.

Directory doubling is logical over a static-capacity directory (2**dmax
physical entries, each always pointing at its owning bucket): it costs
4 * 2**dmax bytes from the start, 4 MiB at dmax 20 and 4 GiB at dmax 30.

The state is a ``TableState`` of torch tensors on one device. Transactions
update the pool and per-bucket tensors **in place** and return the state:
the state passed in is consumed. Control flow that XLA expressed as
``while_loop``/``cond`` is a Python loop reading one device scalar per
round (``telemetry.host_read``, an ``.item()``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.hashing import (EMPTY_KEY, child_bit, dir_index,
                                      hash_fn)

# Operation kinds (paper's Operation.type, plus an inactive lane marker).
NOP = 0
INS = 1
DEL = 2

# The deepest directory: 2**30 int32 entries (4 GiB). The JAX package stops
# at 20 bits; here the CUDA route (``h >> (32 - dmax)``) works for any
# dmax up to 32 less the top hash bits a sharded table spends on the shard.
DMAX_LIMIT = 30

# Result status codes. TRUE/FALSE match the paper's semantics:
#   Insert → TRUE iff the key was newly inserted (FALSE = value updated);
#   Delete → TRUE iff the key was present.
FALSE = 0
TRUE = 1
PENDING = -1   # transient only; never escapes apply_batch unless `error`
FROZEN = -2    # op targeted a frozen bucket (caller must run the merge)
OVERFLOW = -3  # split impossible: bucket already at dmax (hash bits spent)

I32 = torch.int32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Asking for CUDA where there is none raises — nothing
    falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Static configuration of one local table."""

    dmax: int = 8           # max directory depth; capacity = 2**dmax entries
    bucket_size: int = 8    # b: fixed items per bucket (paper uses 8)
    pool_size: int = 256    # bucket pool rows
    n_lanes: int = 16       # n: lanes per combining transaction ("threads")
    hash_name: str = "fmix32"
    hash_shift: int = 0     # drop this many top hash bits (sharded tables)
    initial_depth: int = 0  # start with 2**initial_depth buckets
    max_rounds: int = 0     # 0 → dmax + 2 (structural wait-freedom bound)
    use_fast_path: bool = True  # single-pass combining (rule C); False pins
                                # the serial wave loop (equivalence oracle)

    def __post_init__(self):
        if not 1 <= self.dmax <= DMAX_LIMIT:
            raise ValueError(f"dmax {self.dmax} outside [1, {DMAX_LIMIT}]")
        if self.dmax + self.hash_shift > 32:
            raise ValueError(f"dmax {self.dmax} + hash_shift (a sharded "
                             f"spec's shard_bits) {self.hash_shift} > 32: "
                             f"the route would run out of hash bits")
        assert self.initial_depth <= self.dmax
        assert self.pool_size >= (1 << self.initial_depth)

    @property
    def dcap(self) -> int:
        return 1 << self.dmax

    @property
    def rounds(self) -> int:
        # Each round either applies every still-pending op or strictly
        # deepens a full destination bucket; depth ≤ dmax bounds the chain.
        return self.max_rounds if self.max_rounds > 0 else self.dmax + 2

    @property
    def hash_fn(self):
        return hash_fn(self.hash_name, self.hash_shift)


class TableState(NamedTuple):
    """Device-resident table state. Row ``pool_size`` is a write-trash row
    (masked scatters land there), so pool arrays have pool_size+1 rows."""

    directory: torch.Tensor    # i32[dcap]   physical entry → bucket id
    depth: torch.Tensor        # i32[]       logical directory depth
    keys: torch.Tensor         # i32[P+1, B] EMPTY_KEY = free slot
    vals: torch.Tensor         # i32[P+1, B]
    bdepth: torch.Tensor       # i32[P+1]    bucket depth
    bprefix: torch.Tensor      # i32[P+1]    top-`bdepth` bits
    live: torch.Tensor         # bool[P+1]
    frozen: torch.Tensor       # bool[P+1]   merge freezing (paper §4.5)
    nalloc: torch.Tensor       # i32[]       pool watermark
    free_stack: torch.Tensor   # i32[P+1]    freed bucket ids
    free_top: torch.Tensor     # i32[]
    applied_seq: torch.Tensor  # i32[n]      paper: results[i].seqnum
    last_status: torch.Tensor  # i8[n]       paper: results[i].status
    error: torch.Tensor        # bool[]      capacity/depth exhaustion flag
    counts: torch.Tensor       # i32[P+1]    per-bucket occupancy (row P = 0)
    policy_counts: torch.Tensor  # i32[2]    elastic-policy (splits, merges)


class OpBatch(NamedTuple):
    """The announce array: one op per lane (paper's ``help[n]``)."""

    kind: torch.Tensor   # i32[n] in {NOP, INS, DEL}
    key: torch.Tensor    # i32[n]
    value: torch.Tensor  # i32[n]
    seq: torch.Tensor    # i32[n] per-lane opSeqnum


class BatchResult(NamedTuple):
    status: torch.Tensor  # i8[n]
    error: torch.Tensor   # bool[]


# ---------------------------------------------------------------------------
# construction and host export


def init_table(cfg: TableConfig, device=None) -> TableState:
    dev = resolve_device(device)
    with telemetry.span("repro.core.init_table"):
        P, B, n = cfg.pool_size, cfg.bucket_size, cfg.n_lanes
        nb = 1 << cfg.initial_depth
        shift = cfg.dmax - cfg.initial_depth
        live = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        live[:nb] = True
        bdepth = torch.zeros(P + 1, dtype=I32, device=dev)
        bdepth[:nb] = cfg.initial_depth
        bprefix = torch.zeros(P + 1, dtype=I32, device=dev)
        bprefix[:nb] = torch.arange(nb, dtype=I32, device=dev)
        scalar = lambda v, dt=I32: torch.tensor(v, dtype=dt, device=dev)
        directory = torch.arange(cfg.dcap, dtype=I32, device=dev)
        directory >>= shift      # in place: no second directory-sized buffer
        return TableState(
            directory=directory,
            depth=scalar(cfg.initial_depth),
            keys=torch.full((P + 1, B), EMPTY_KEY, dtype=I32, device=dev),
            vals=torch.zeros((P + 1, B), dtype=I32, device=dev),
            bdepth=bdepth,
            bprefix=bprefix,
            live=live,
            frozen=torch.zeros(P + 1, dtype=torch.bool, device=dev),
            nalloc=scalar(nb),
            free_stack=torch.zeros(P + 1, dtype=I32, device=dev),
            free_top=scalar(0),
            applied_seq=torch.zeros(n, dtype=I32, device=dev),
            last_status=torch.zeros(n, dtype=torch.int8, device=dev),
            error=scalar(False, torch.bool),
            counts=torch.zeros(P + 1, dtype=I32, device=dev),
            policy_counts=torch.zeros(2, dtype=I32, device=dev),
        )


_NP_DTYPES = {torch.int32: np.int32, torch.int8: np.int8,
              torch.bool: np.bool_}


def to_numpy(state: TableState) -> dict:
    """Host copy of a state: numpy arrays named like the ``TableState``
    fields, with the JAX package's dtypes (int32 / int8 / bool)."""
    return {name: t.detach().cpu().numpy().astype(_NP_DTYPES[t.dtype])
            for name, t in state._asdict().items()}


def from_numpy_state(d: dict, device=None) -> TableState:
    """Inverse of :func:`to_numpy` (also takes the fields of a JAX
    ``TableState`` as numpy arrays): every field onto ``device``. A sharded
    table's state — the JAX package's or this port's — is the same fields
    with a leading ``[n_shards]`` axis, and loads the same way."""
    dev = resolve_device(device)
    return TableState(**{name: torch.tensor(np.asarray(d[name]), device=dev)
                         for name in TableState._fields})


# ---------------------------------------------------------------------------
# rule (A): synchronization-free lookups


def probe_rows(bucket_ids, queries, pool_keys, pool_vals):
    """Probe the pool rows ``bucket_ids`` for ``queries``. Returns (found
    bool[m], values i32[m], -1 where absent); the first matching slot
    answers, and the sentinel ``EMPTY_KEY`` never matches."""
    b = bucket_ids.long()
    eq = (pool_keys[b] == queries[:, None]) & (queries != EMPTY_KEY)[:, None]
    found = eq.any(dim=-1)
    val = pool_vals[b].gather(1, _first_true(eq)[:, None].long())[:, 0]
    return found, torch.where(found, val, -1)


def probe(directory, queries, pool_keys, pool_vals, *, dmax: int, hash):
    """Route ``queries`` through ``directory`` (top ``dmax`` bits of
    ``hash(q)``) and probe their pool rows (:func:`probe_rows`)."""
    return probe_rows(directory[dir_index(hash(queries), dmax)], queries,
                      pool_keys, pool_vals)


def lookup(cfg: TableConfig, state: TableState, queries: torch.Tensor):
    """Paper lines 32-35, vectorized: a pure gather on the current state.

    The plain probe: the contract of the fused probe kernel
    (``kernels/lookup.py``), under which an ``EMPTY_KEY`` query is never
    found (the JAX package's ``table.lookup`` matches it to a free slot)."""
    return probe(state.directory, queries, state.keys, state.vals,
                 dmax=cfg.dmax, hash=cfg.hash_fn)


# ---------------------------------------------------------------------------
# the combining transaction


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 if none (the
    ``jnp.argmax`` of a bool mask; torch's argmax takes no bool)."""
    return mask.to(I32).argmax(dim=-1)


def _route(cfg: TableConfig, directory, keys):
    h = cfg.hash_fn(keys)
    return h, directory[dir_index(h, cfg.dmax)]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def group_ranks(bucket, mask):
    """Rank of each masked lane within its bucket group, in (bucket, lane)
    order — the linearization order of a combining round; -1 elsewhere."""
    n = bucket.shape[0]
    sort_key = torch.where(mask, bucket.to(torch.int64), 1 << 40)
    order = torch.argsort(sort_key, stable=True)
    sorted_b = sort_key[order]
    iota = _iota(n, bucket.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=iota.device),
                          sorted_b[1:] != sorted_b[:-1]])
    start = _cummax(torch.where(is_start, iota, -1))
    rank = torch.zeros(n, dtype=I32, device=iota.device)
    rank[order] = (iota - start).to(I32)
    return torch.where(mask, rank, -1)


def _seg_base(start: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Broadcast ``values`` at segment starts over their segment."""
    head = _cummax(torch.where(start, _iota(start.shape[0], start.device),
                               -1))
    return values[head.long()]


# Up to this lane count the segmented quantities are computed by O(n²)
# masked reductions; wider batches switch to O(n log n) sort-based scans.
_PAIRWISE_MAX_LANES = 256


def _links_pairwise(cfg, ops, active, b_act, exist0, delta_of):
    """(present, delta, occ_excl, blocked_from, last_applied_of, rank_of)
    via masked [n, n] reductions (contract shared with _links_sorted).

    Row i ranges over candidate predecessors/successors j: ``before`` is
    the lane order, ``same_b``/``same_bk`` the bucket / (bucket, key)
    segmentation."""
    n = cfg.n_lanes
    lane = _iota(n, active.device)
    li, lj = lane[:, None], lane[None, :]
    before = lj < li
    same_b = (active[:, None] & active[None, :]
              & (b_act[:, None] == b_act[None, :]))
    same_bk = same_b & (ops.key[:, None] == ops.key[None, :])

    prev = torch.where(same_bk & before, lj, -1).amax(dim=1)
    present = torch.where(prev >= 0,
                          ops.kind[prev.clamp(min=0).long()] == INS, exist0)
    delta = delta_of(present)
    occ_excl = torch.where(same_b & before, delta[None, :], 0).sum(dim=1)

    def blocked_from(viol):
        # the first violating op of a bucket blocks itself and every later
        # op of the group (a full bucket admits no update — the suffix rule)
        return (same_b & (lj <= li) & viol[None, :]).any(dim=1)

    def last_applied_of(applied):
        return applied & ~(same_bk & (lj > li) & applied[None, :]).any(dim=1)

    def rank_of(flag):
        return (same_b & before & flag[None, :]).sum(dim=1)

    return present, delta, occ_excl, blocked_from, last_applied_of, rank_of


def _links_sorted(cfg, ops, active, b_act, exist0, delta_of):
    """Same contract as :func:`_links_pairwise` via sorted segmented scans:
    a lexicographic (bucket, key, lane) order drives the presence chains,
    a (bucket, lane) order the occupancy prefix sums, broadcasts and ranks.
    Stable sorts from lane order give both lexicographic orders."""
    n = cfg.n_lanes
    dev = active.device
    by_key = torch.argsort(ops.key, stable=True)
    ls = by_key[torch.argsort(b_act[by_key], stable=True)]
    bs, ks = b_act[ls], ops.key[ls]
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    same_run = torch.cat([no, (bs[1:] == bs[:-1]) & (ks[1:] == ks[:-1])])
    prev_ins = torch.cat([no, ops.kind[ls][:-1] == INS])
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    present[ls] = torch.where(same_run, prev_ins, exist0[ls])
    delta = delta_of(present)

    ls2 = torch.argsort(b_act, stable=True)
    bs2 = b_act[ls2]
    seg2 = torch.cat([~no, bs2[1:] != bs2[:-1]])

    def seg_excl(x_sorted):
        pre = torch.cumsum(x_sorted, dim=0) - x_sorted
        return pre - _seg_base(seg2, pre)

    def unsort(order, x_sorted, dtype):
        out = torch.zeros(n, dtype=dtype, device=dev)
        out[order] = x_sorted.to(dtype)
        return out

    occ_excl = unsort(ls2, seg_excl(delta[ls2]), I32)

    def blocked_from(viol):
        # inclusive segmented OR along (bucket, lane): any violation at or
        # before me in my bucket blocks me (the suffix rule)
        v = viol[ls2].to(I32)
        return unsort(ls2, (seg_excl(v) + v) > 0, torch.bool)

    def last_applied_of(applied):
        # applied is a lane-prefix of every bucket group, hence of every
        # (bucket, key) run: last-applied = applied with no applied
        # successor in the run (the run's next op, if any, sits at i+1)
        ap = applied[ls]
        nxt = torch.cat([same_run[1:] & ap[1:], no])
        return unsort(ls, ap & ~nxt, torch.bool)

    def rank_of(flag):
        return unsort(ls2, seg_excl(flag[ls2].to(I32)), I32)

    return present, delta, occ_excl, blocked_from, last_applied_of, rank_of


def _fast_pass(cfg: TableConfig, st: TableState, ops: OpBatch, pending,
               status):
    """Single-pass combining: segmented slot assignment + one install.

    The announced batch is linearized as (bucket, lane) and applied at
    once: presence chains over (bucket, key) runs resolve intra-batch
    duplicate keys; a segmented exclusive prefix sum of ±1 slot deltas
    gives each op its occupancy at its turn, and the first op that would
    find its bucket full blocks itself and the rest of its group (nothing
    leaves a full bucket) — those stay pending on exactly-full buckets for
    the split pass. Applied ops commit with two sequenced scatters."""
    P, B, n = cfg.pool_size, cfg.bucket_size, cfg.n_lanes
    dev = pending.device
    _, bucket = _route(cfg, st.directory, ops.key)
    bucket = torch.where(pending, bucket, P)

    frozen_hit = pending & st.frozen[bucket.long()]
    active = pending & ~frozen_hit
    b_act = torch.where(active, bucket, P)
    is_ins = active & (ops.kind == INS)
    is_del = active & (ops.kind == DEL)

    rows_k = st.keys[b_act.long()]                  # [n, B] snapshot rows
    eq0 = rows_k == ops.key[:, None]
    exist0 = active & eq0.any(dim=-1)
    slot_eq = _first_true(eq0)

    def delta_of(present):
        return (is_ins & ~present).to(I32) - (is_del & present).to(I32)

    links = (_links_pairwise if n <= _PAIRWISE_MAX_LANES else _links_sorted)
    present, delta, occ_excl, blocked_from, last_applied_of, rank_of = links(
        cfg, ops, active, b_act, exist0, delta_of)

    # the full test comes FIRST: an op at occupancy B fails even if a later
    # delete would have made room; the blocked suffix stays pending
    viol = active & (st.counts[b_act.long()] + occ_excl >= B)
    applied = active & ~blocked_from(viol)

    op_status = torch.where(ops.kind == INS, ~present, present).to(torch.int8)
    status = torch.where(applied, op_status, status)
    status = torch.where(frozen_hit, FROZEN, status).to(torch.int8)
    done = applied | frozen_hit
    applied_seq = torch.where(done, ops.seq, st.applied_seq)
    pending = pending & ~done

    # install: only the LAST applied op of each (bucket, key) run writes
    last_applied = last_applied_of(applied)
    del_clear = last_applied & (ops.kind == DEL) & exist0
    ins_over = last_applied & (ops.kind == INS) & exist0
    ins_new = last_applied & (ops.kind == INS) & ~exist0

    # fresh inserts: segmented rank within the bucket → r-th free slot of
    # (initially-empty ∪ delete-cleared)
    rank = rank_of(ins_new)
    if n <= _PAIRWISE_MAX_LANES:
        same_grp = (active[:, None] & active[None, :]
                    & (b_act[:, None] == b_act[None, :]))        # [n, n]
        col_hit = (slot_eq[None, :, None]
                   == _iota(B, dev)[None, None, :])              # [1, n, B]
        freed_rows = ((same_grp & del_clear[None, :])[:, :, None]
                      & col_hit).any(dim=1)                      # [n, B]
    else:
        cleared = torch.zeros((P + 1, B), dtype=torch.bool, device=dev)
        telemetry.host_write("fast_pass", cleared,
                             (torch.where(del_clear, b_act, P).long(),
                              slot_eq.long()), True)
        freed_rows = cleared[b_act.long()]
    free_rows = (rows_k == EMPTY_KEY) | freed_rows
    csum = torch.cumsum(free_rows.to(I32), dim=-1)
    slot_new = _first_true(free_rows & (csum == (rank + 1)[:, None]))

    # two SEQUENCED scatters: slot_eq writers (delete-clears + in-place
    # updates) first, fresh inserts second — a fresh insert may claim a
    # delete-freed slot, and within one scatter duplicate indices (which
    # only the trash row ever receives) land in unspecified order
    keys, vals = st.keys, st.vals
    w_eq = del_clear | ins_over
    r_eq = torch.where(w_eq, b_act, P).long()
    keys[r_eq, slot_eq.long()] = torch.where(ins_over, ops.key, EMPTY_KEY)
    vals[r_eq, slot_eq.long()] = torch.where(ins_over, ops.value, 0)
    r_new = torch.where(ins_new, b_act, P).long()
    keys[r_new, slot_new.long()] = torch.where(ins_new, ops.key, EMPTY_KEY)
    vals[r_new, slot_new.long()] = torch.where(ins_new, ops.value, 0)

    st.counts.index_add_(0, b_act.long(),
                         torch.where(applied, delta, 0).to(I32))
    st = st._replace(applied_seq=applied_seq)
    return st, pending, status


def wave_combine(pool_keys, pool_vals, frozen, bucket, mask, kinds, keys,
                 values):
    """Apply the masked ops to their buckets' rows in lane order, in waves:
    wave w executes the w-th op of every bucket group at once — disjoint
    buckets progress in parallel (rule B), and within a bucket the lane
    order holds. Paper ExecOnBucket: the full test comes FIRST — no update
    (not even a Delete) runs on a full bucket; a frozen bucket blocks every
    update. The pools [P+1, B] are updated in place (the trash row P takes
    the idle lanes' writes). Returns bool[n] masks ``(applied, full,
    frozen_hit, exist)``: ``exist`` is whether the key was in its row at
    the op's turn (set for applied lanes only)."""
    P = pool_keys.shape[0] - 1
    frozen_hit = mask & frozen[bucket.long()]
    active = mask & ~frozen_hit
    rank = group_ranks(bucket, active)         # -1 for idle lanes
    is_ins = kinds == INS
    new_key = torch.where(is_ins, keys, EMPTY_KEY)
    new_val = torch.where(is_ins, values, 0)
    full_hit = torch.zeros_like(mask)
    exist_at = torch.zeros_like(mask)
    waves = (telemetry.host_read("waves", rank.max()) + 1
             if rank.numel() else 0)
    telemetry.count("slow.waves", waves)
    for w in range(waves):
        sel = rank == w
        row = torch.where(sel, bucket, P).long()
        rows_k = pool_keys[row]
        occ = rows_k != EMPTY_KEY
        full = occ.all(dim=-1)
        eq = rows_k == keys[:, None]
        exist = eq.any(dim=-1)
        slot = torch.where(is_ins & ~exist, _first_true(~occ),
                           _first_true(eq)).long()
        do_write = sel & ~full & (is_ins | exist)   # DEL of absent: no-op
        wrow = torch.where(do_write, row, P)
        pool_keys[wrow, slot] = torch.where(do_write, new_key, EMPTY_KEY)
        pool_vals[wrow, slot] = torch.where(do_write, new_val, 0)
        full_hit |= sel & full
        exist_at |= sel & ~full & exist
    return active & ~full_hit, full_hit, frozen_hit, exist_at


def _wave_pass(cfg: TableConfig, st: TableState, ops: OpBatch, pending,
               status):
    """Apply every pending op whose destination allows it (ApplyWFOp,
    :func:`wave_combine`). An op that finds its bucket full stays
    pending."""
    P = cfg.pool_size
    _, bucket = _route(cfg, st.directory, ops.key)
    applied, _, frozen_hit, exist = wave_combine(
        st.keys, st.vals, st.frozen, bucket, pending, ops.kind, ops.key,
        ops.value)
    is_ins = ops.kind == INS
    dcount = ((applied & is_ins & ~exist).to(I32)
              - (applied & ~is_ins & exist).to(I32))
    st.counts.index_add_(0, torch.where(applied, bucket, P).long(), dcount)
    telemetry.host_write("wave_pass", st.counts, P, 0)

    op_status = torch.where(is_ins, ~exist, exist).to(torch.int8)
    status = torch.where(applied, op_status, status)
    status = torch.where(frozen_hit, FROZEN, status).to(torch.int8)
    done = applied | frozen_hit
    applied_seq = torch.where(done, ops.seq, st.applied_seq)
    return st._replace(applied_seq=applied_seq), pending & ~done, status


def _alloc_pairs(cfg: TableConfig, st: TableState, k, k_max: int):
    """Allocate 2*k bucket ids: pop the free stack first (local-heap
    reuse, paper §5), then advance the watermark. Returns (ids[2*k_max],
    st). Ids past an exhausted pool are clamped to the trash row (the
    error flag is set; JAX drops such out-of-range writes instead)."""
    P = cfg.pool_size
    j = _iota(2 * k_max, st.nalloc.device)
    from_stack = j < st.free_top
    stack_idx = torch.clamp(st.free_top - 1 - j, 0, P).long()
    ids = torch.where(from_stack, st.free_stack[stack_idx],
                      st.nalloc + j - st.free_top).clamp(max=P)
    need = 2 * k
    pop = torch.minimum(need, st.free_top)
    grow = need - pop
    error = st.error | (st.nalloc + grow > P)
    return ids.to(I32), st._replace(
        free_top=(st.free_top - pop).to(I32),
        nalloc=torch.clamp(st.nalloc + grow, max=P).to(I32),
        error=error,
    )


def _do_splits(cfg: TableConfig, st: TableState, split_ids, valid):
    """SplitBucket + DirectoryUpdate for up to ``k_max`` buckets at once.

    ``split_ids`` i32[k_max] names the parents (masked entries become the
    trash row via ``valid``); the pass allocates child pairs, moves items
    by the (depth+1)-th hash bit, retires the parents onto the free stack
    and rewrites each parent's directory range in place. Returns
    ``(state, k_split)``."""
    P, B = cfg.pool_size, cfg.bucket_size
    dev = split_ids.device
    k_max = split_ids.shape[0]
    split_ids = torch.where(valid, split_ids, P).long()
    k = valid.sum().to(I32)

    ids_all, st = _alloc_pairs(cfg, st, k, k_max)
    rankpos = torch.arange(k_max, device=dev)
    id0 = torch.where(valid, ids_all[2 * rankpos], P).long()
    id1 = torch.where(valid, ids_all[2 * rankpos + 1], P).long()

    # --- SplitBucket: redistribute parent items by the (depth+1)-th bit ---
    pk = st.keys[split_ids]                      # [k_max, B]
    pv = st.vals[split_ids]
    pd = st.bdepth[split_ids]
    pp = st.bprefix[split_ids]
    occ = pk != EMPTY_KEY
    bit = child_bit(cfg.hash_fn(pk), pd[:, None])
    to0 = occ & (bit == 0)
    to1 = occ & (bit == 1)

    def compact(mask, src, fill):
        pos = torch.where(mask, torch.cumsum(mask.to(I32), dim=-1) - 1, B)
        out = torch.full((k_max, B + 1), fill, dtype=src.dtype, device=dev)
        out[torch.arange(k_max, device=dev)[:, None], pos.long()] = \
            torch.where(mask, src, fill)             # column B = trash
        return out[:, :B]

    keys, vals = st.keys, st.vals
    keys[id0] = compact(to0, pk, EMPTY_KEY)
    keys[id1] = compact(to1, pk, EMPTY_KEY)
    vals[id0] = compact(to0, pv, 0)
    vals[id1] = compact(to1, pv, 0)
    # incremental occupancy: children get their redistribution counts
    counts, bdepth, bprefix = st.counts, st.bdepth, st.bprefix
    live, frozen = st.live, st.frozen
    counts[id0] = to0.sum(dim=-1).to(I32)
    counts[id1] = to1.sum(dim=-1).to(I32)
    bdepth[id0] = pd + 1
    bdepth[id1] = pd + 1
    bprefix[id0] = pp * 2
    bprefix[id1] = pp * 2 + 1
    telemetry.host_write("splits", live, id0, True)
    telemetry.host_write("splits", live, id1, True)
    telemetry.host_write("splits", frozen, id0, False)
    telemetry.host_write("splits", frozen, id1, False)

    # retire parents: dead + pushed on the free stack for reuse
    dead_ids = split_ids
    telemetry.host_write("splits", live, dead_ids, False)
    telemetry.host_write("splits", live, P, False)
    telemetry.host_write("splits", counts, dead_ids, 0)
    telemetry.host_write("splits", counts, P, 0)
    push_pos = torch.where(
        valid, st.free_top + torch.cumsum(valid.to(I32), dim=0) - 1, P)
    st.free_stack[push_pos.long()] = split_ids.to(I32)
    free_top = (st.free_top + k).to(I32)

    # --- DirectoryUpdate: each parent's range, and nothing else ---
    # a parent at depth pd owns 2**(dmax - pd) entries from pp << (dmax -
    # pd): the lower half goes to id0, the upper to id1. One pass's parents
    # are distinct live buckets, so their ranges are disjoint; their total
    # sizes the pass (one read), never the 2**dmax directory
    shift = (cfg.dmax - pd).clamp(min=0).long()
    size = torch.where(valid, torch.ones_like(shift) << shift, 0)
    total = telemetry.host_read("splits", size.sum())
    telemetry.count("slow.dir_writes", total)
    which = torch.repeat_interleave(rankpos, size, output_size=total)
    off = _iota(total, dev) - (torch.cumsum(size, 0) - size)[which]
    st.directory[(pp.long() << shift)[which] + off] = torch.where(
        off < size[which] >> 1, id0[which], id1[which]).to(I32)
    # logical doubling: a scalar bump — the physical directory is static
    depth = torch.maximum(st.depth,
                          torch.where(valid, pd + 1, 0).max()).to(I32)
    st = st._replace(depth=depth, free_top=free_top)
    return st, k


def _split_pass(cfg: TableConfig, st: TableState, ops: OpBatch, pending,
                status):
    """SplitBucket + DirectoryUpdate + ApplyPendingResize's re-routing.

    Every full bucket targeted by a still-pending op is split once; pending
    ops re-route through the updated directory on the next round."""
    P, B, n = cfg.pool_size, cfg.bucket_size, cfg.n_lanes
    dev = pending.device
    _, bucket = _route(cfg, st.directory, ops.key)
    bucket = bucket.long()

    needs = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    telemetry.host_write("split_pass", needs,
                         torch.where(pending, bucket, P), True)
    needs = needs & st.live & ~st.frozen & (st.counts == B)
    telemetry.host_write("split_pass", needs, P, False)
    # a bucket already at dmax cannot split: the hash bits are exhausted
    stuck = needs & (st.bdepth >= cfg.dmax)
    splittable = needs & (st.bdepth < cfg.dmax)
    op_stuck = pending & stuck[bucket]
    status = torch.where(op_stuck, OVERFLOW, status).to(torch.int8)
    applied_seq = torch.where(op_stuck, ops.seq, st.applied_seq)
    pending = pending & ~op_stuck
    st = st._replace(error=st.error | stuck.any(), applied_seq=applied_seq)

    split_ids = torch.sort(torch.where(splittable, _iota(P + 1, dev),
                                       P)).values[:n]
    st, _ = _do_splits(cfg, st, split_ids, split_ids < P)
    return st, pending, status


def apply_batch(cfg: TableConfig, state: TableState, ops: OpBatch):
    """One wait-free combining transaction over the announced op batch.

    At most ``cfg.rounds`` rounds of [split-full-destinations → apply what
    fits] after the single fast pass. Replayed sequence numbers (seq ≤
    applied_seq) are not re-executed — they return the stored result (the
    exactly-once test of paper lines 55/103). ``state`` is consumed."""
    n = cfg.n_lanes
    assert ops.kind.shape == (n,), (ops.kind.shape, n)
    with telemetry.span("repro.core.apply_batch"):
        fresh = (ops.kind != NOP) & (ops.seq > state.applied_seq)
        replay = (ops.kind != NOP) & ~fresh
        status = torch.full((n,), PENDING, dtype=torch.int8,
                            device=ops.kind.device)

        st, pending = state, fresh
        if cfg.use_fast_path:
            st, pending, status = _fast_pass(cfg, st, ops, pending, status)

        # overflow fallback: bounded split/wave rounds (FAIL → ResizeWF)
        r = 0
        while r < cfg.rounds and telemetry.host_read("pending",
                                                     pending.any()):
            telemetry.count("slow.rounds")
            if cfg.use_fast_path:
                st, pending, status = _split_pass(cfg, st, ops, pending,
                                                  status)
                st, pending, status = _wave_pass(cfg, st, ops, pending,
                                                 status)
            else:
                st, pending, status = _wave_pass(cfg, st, ops, pending,
                                                 status)
                if telemetry.host_read("pending", pending.any()):
                    st, pending, status = _split_pass(cfg, st, ops, pending,
                                                      status)
            r += 1
        # wait-freedom: anything still pending is capacity exhaustion
        st = st._replace(error=st.error | pending.any())
        status = torch.where(replay, st.last_status, status)
        final = torch.where(ops.kind == NOP, st.last_status, status)
        st = st._replace(last_status=final)
        return st, BatchResult(status=final, error=st.error)


# ---------------------------------------------------------------------------
# announce helpers


def _validate_ops(kinds, keys, values, device):
    """Canonicalize an op batch to matching 1-d i32 tensors (or raise)."""
    kinds = torch.as_tensor(kinds, dtype=I32, device=device)
    keys = torch.as_tensor(keys, dtype=I32, device=device)
    values = (torch.zeros_like(keys) if values is None
              else torch.as_tensor(values, dtype=I32, device=device))
    if not (kinds.ndim == 1 and kinds.shape == keys.shape == values.shape):
        raise ValueError(
            f"op batch must be matching 1-d arrays; got kinds "
            f"{tuple(kinds.shape)}, keys {tuple(keys.shape)}, values "
            f"{tuple(values.shape)}")
    return kinds, keys, values


def pad_ops(cfg: TableConfig, kinds, keys, values=None, device=None):
    """NOP-fill a short op batch to exactly ``cfg.n_lanes`` lanes."""
    kinds, keys, values = _validate_ops(kinds, keys, values,
                                        resolve_device(device))
    m = kinds.shape[0]
    if m > cfg.n_lanes:
        raise ValueError(
            f"batch of {m} ops exceeds n_lanes={cfg.n_lanes}; chunk it "
            "(repro_torch.table_api.Table.apply handles any batch length)")
    pad = cfg.n_lanes - m
    if pad:
        kinds, keys, values = (torch.nn.functional.pad(x, (0, pad))
                               for x in (kinds, keys, values))   # NOP == 0
    return kinds, keys, values


def make_ops(cfg: TableConfig, state: TableState, kinds, keys, values=None):
    """Build an OpBatch with fresh per-lane sequence numbers, on the
    state's device. Inputs must be 1-d of length exactly ``n_lanes``."""
    kinds, keys, values = _validate_ops(kinds, keys, values,
                                        state.keys.device)
    if kinds.shape[0] != cfg.n_lanes:
        raise ValueError(
            f"op batch has {kinds.shape[0]} lanes, config has "
            f"n_lanes={cfg.n_lanes}; NOP-fill short batches with pad_ops() "
            "or use repro_torch.table_api.Table for any batch length")
    return OpBatch(kind=kinds, key=keys, value=values,
                   seq=state.applied_seq + 1)


def insert_batch(cfg: TableConfig, state: TableState, keys, values):
    """One transaction upserting ``keys`` (exactly ``n_lanes`` of them)."""
    ops = make_ops(cfg, state, torch.full((cfg.n_lanes,), INS, dtype=I32),
                   keys, values)
    return apply_batch(cfg, state, ops)


def delete_batch(cfg: TableConfig, state: TableState, keys):
    """One transaction deleting ``keys`` (exactly ``n_lanes`` of them)."""
    ops = make_ops(cfg, state, torch.full((cfg.n_lanes,), DEL, dtype=I32),
                   keys)
    return apply_batch(cfg, state, ops)


def table_size(state: TableState) -> torch.Tensor:
    # O(P) read of the incremental occupancy counts — no pool-wide recount
    return torch.where(state.live, state.counts, 0).sum()


# ---------------------------------------------------------------------------
# merging & freezing (paper §4.5)


def _buddy_ids(cfg: TableConfig, state: TableState, parent_prefix: int,
               parent_depth: int):
    if not 0 <= parent_depth < cfg.dmax:
        raise ValueError(f"parent_depth {parent_depth} outside "
                         f"[0, dmax={cfg.dmax})")
    shift = cfg.dmax - (parent_depth + 1)
    b0 = state.directory[(parent_prefix * 2) << shift].long()
    b1 = state.directory[(parent_prefix * 2 + 1) << shift].long()
    return b0, b1


def freeze_buddies(cfg: TableConfig, state: TableState, parent_prefix: int,
                   parent_depth: int):
    """Freeze the two buddy buckets of a would-be parent (prefix order —
    the paper's deadlock-avoidance rule). ``ok`` is False if either buddy
    is full, already frozen, or not at depth parent_depth+1."""
    P, B = cfg.pool_size, cfg.bucket_size
    d1 = parent_depth + 1
    b0, b1 = _buddy_ids(cfg, state, parent_prefix, parent_depth)
    c0, c1 = state.counts[b0], state.counts[b1]
    ok = ((b0 != b1)
          & (state.bdepth[b0] == d1) & (state.bdepth[b1] == d1)
          & ~state.frozen[b0] & ~state.frozen[b1]
          & (c0 < B) & (c1 < B) & (c0 + c1 <= B))
    frozen = state.frozen
    frozen[torch.where(ok, b0, P)] = True
    frozen[torch.where(ok, b1, P)] = True
    frozen[P] = False
    return state, ok


def merge_buddies(cfg: TableConfig, state: TableState, parent_prefix: int,
                  parent_depth: int):
    """Merge two frozen buddies back into their parent (ResizeWF merge
    path), as one transaction: freeze → merge → unfreeze. Returns
    (state, ok); the directory depth shrinks logically."""
    P, B = cfg.pool_size, cfg.bucket_size
    dev = state.keys.device
    state, ok = freeze_buddies(cfg, state, parent_prefix, parent_depth)
    b0, b1 = _buddy_ids(cfg, state, parent_prefix, parent_depth)

    # allocate the parent bucket
    have_free = state.free_top > 0
    new_id = torch.where(
        have_free, state.free_stack[torch.clamp(state.free_top - 1, min=0)],
        state.nalloc)
    error = state.error | (~have_free & (state.nalloc >= P) & ok)
    new_id = torch.where(ok, new_id, P).long()
    free_top = torch.where(ok & have_free, state.free_top - 1,
                           state.free_top)
    nalloc = torch.where(ok & ~have_free, torch.clamp(state.nalloc + 1,
                                                      max=P), state.nalloc)

    k0, v0 = state.keys[b0], state.vals[b0]
    k1, v1 = state.keys[b1], state.vals[b1]
    occ0 = k0 != EMPTY_KEY
    occ1 = k1 != EMPTY_KEY
    pos0 = torch.where(occ0, torch.cumsum(occ0.to(I32), 0) - 1, B)
    pos1 = torch.where(occ1, occ0.sum() + torch.cumsum(occ1.to(I32), 0) - 1,
                       B).clamp(max=B)   # past B only when not ok (unused)
    mk = torch.full((B + 1,), EMPTY_KEY, dtype=I32, device=dev)
    mk[pos0.long()] = torch.where(occ0, k0, EMPTY_KEY)
    mk[pos1.long()] = torch.where(occ1, k1, EMPTY_KEY)
    mv = torch.zeros(B + 1, dtype=I32, device=dev)
    mv[pos0.long()] = torch.where(occ0, v0, 0)
    mv[pos1.long()] = torch.where(occ1, v1, 0)
    merged_count = state.counts[b0] + state.counts[b1]

    keys, vals, counts = state.keys, state.vals, state.counts
    bdepth, bprefix, live = state.bdepth, state.bprefix, state.live
    keys[new_id] = torch.where(ok, mk[:B], keys[new_id])
    vals[new_id] = torch.where(ok, mv[:B], vals[new_id])
    counts[new_id] = torch.where(ok, merged_count, counts[new_id])
    bdepth[new_id] = torch.where(ok, parent_depth, bdepth[new_id])
    bprefix[new_id] = torch.where(ok, parent_prefix, bprefix[new_id])
    live[new_id] = True
    dead0 = torch.where(ok, b0, P)
    dead1 = torch.where(ok, b1, P)
    for t, v in ((live, False), (counts, 0), (state.frozen, False)):
        t[dead0] = v
        t[dead1] = v
        t[P] = v
    # merged children die; the parent starts unfrozen
    state.frozen[new_id] = False
    state.frozen[P] = False
    # push children on the free stack
    push0 = torch.where(ok, free_top, P).long()
    push1 = torch.where(ok, free_top + 1, P).long()
    state.free_stack[push0] = b0.to(I32)
    state.free_stack[push1] = b1.to(I32)
    free_top = torch.where(ok, free_top + 2, free_top)

    # directory: the parent's whole range points at the merged bucket
    shift = max(cfg.dmax - parent_depth, 0)
    rng = state.directory[parent_prefix << shift:(parent_prefix + 1) << shift]
    rng.copy_(torch.where(ok, new_id.to(I32), rng))
    # logical shrink: recompute the depth scalar from live buckets
    depth = torch.where(live, bdepth, 0).max()

    st = state._replace(
        depth=depth.to(I32), nalloc=nalloc.to(I32),
        free_top=free_top.to(I32), error=error)
    return st, ok
