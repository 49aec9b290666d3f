"""Elastic resize policy: watermark-driven proactive splits and buddy merges.

The port of ``repro/core/policy.py``. The paper's resize actions are purely
*reactive*: a bucket splits only when an update finds it full, and the
§4.5 merge path (``freeze_buddies`` / ``merge_buddies``) has no driver.
:class:`ResizePolicy` closes that loop. After every combining transaction
the policy runs two bounded maintenance passes over the incremental
occupancy counts (``TableState.counts``):

* **split pass** — buckets at or above the high watermark
  (``ceil(split_watermark * bucket_size)`` items) are split before they
  overflow, at most ``max_splits`` per transaction;
* **merge pass** — buddy pairs whose combined occupancy is at or below the
  low watermark (``floor(merge_watermark * bucket_size)`` items) are merged
  back into their parent through the freeze → merge → unfreeze
  transaction, deepest pair first (coldest within a depth), at most
  ``max_merges`` per transaction.

``merge_watermark < split_watermark`` makes the two thresholds a
hysteresis band: a freshly split parent's children cannot immediately
re-merge, and a freshly merged parent cannot immediately re-split, so
oscillating traffic must cross the whole band between two resize actions
on one region.

The policy is content-transparent: it changes only the bucket layout,
never the key → value map or any op's status. Cumulative actions are
recorded in ``TableState.policy_counts`` (i32[2]: splits, merges).

The split pass stays on the device. The merge pass reads each merge
candidate's ``(ok, prefix, depth)`` to the host (``merge_buddies`` takes
Python ints): one host read per attempt, at most ``max_merges`` per
transaction, and one when no pair qualifies (the pass stops at the first
attempt that finds none: the state has not changed, so neither would the
answer).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import table as T


@dataclasses.dataclass(frozen=True)
class ResizePolicy:
    """Watermark policy knobs (frozen and hashable).

    ``split_watermark`` / ``merge_watermark`` are occupancy fractions of
    ``bucket_size``; ``max_splits`` / ``max_merges`` are per-transaction
    action budgets (the wait-freedom bound); ``min_depth`` floors the
    directory depth a merge may shrink to (a table configured with
    ``initial_depth`` typically pins ``min_depth`` to it, so that the
    steady-state layout never collapses below its provisioned floor).
    """

    split_watermark: float = 0.875   # split when count >= ceil(hi * B)
    merge_watermark: float = 0.25    # merge when combined <= floor(lo * B)
    max_splits: int = 8
    max_merges: int = 2
    min_depth: int = 0

    def __post_init__(self):
        if not 0.0 < self.merge_watermark < self.split_watermark <= 1.0:
            raise ValueError(
                "need 0 < merge_watermark < split_watermark <= 1 "
                f"(hysteresis); got merge {self.merge_watermark}, split "
                f"{self.split_watermark}")
        if self.max_splits < 0 or self.max_merges < 0 or self.min_depth < 0:
            raise ValueError("max_splits, max_merges and min_depth must be "
                             "non-negative")

    def thresholds(self, bucket_size: int) -> tuple[int, int]:
        """(hi, lo) item thresholds for a bucket size: split at count >= hi,
        merge at combined <= lo."""
        hi = math.ceil(self.split_watermark * bucket_size)
        lo = math.floor(self.merge_watermark * bucket_size)
        return hi, lo

    def validate(self, bucket_size: int, dmax: int) -> None:
        """Bucket-size-dependent checks (done by TableSpec at
        construction)."""
        hi, lo = self.thresholds(bucket_size)
        if not lo < hi:
            raise ValueError(
                f"degenerate hysteresis band for bucket_size={bucket_size}: "
                f"merge threshold {lo} must sit strictly below split "
                f"threshold {hi}")
        if hi < 2:
            raise ValueError(
                f"split_watermark={self.split_watermark} splits near-empty "
                f"buckets at bucket_size={bucket_size}")
        if self.min_depth > dmax:
            raise ValueError(f"min_depth {self.min_depth} > dmax {dmax}")


def _policy_split(cfg: T.TableConfig, policy: ResizePolicy,
                  st: T.TableState) -> T.TableState:
    """Proactively split up to ``max_splits`` lowest-id buckets at or above
    the high watermark. Skips silently (no error flag) when the pool or the
    hash bits are exhausted — proactive work is an optimization, never an
    obligation."""
    P = cfg.pool_size
    hi, _ = policy.thresholds(cfg.bucket_size)
    hot = st.live & ~st.frozen & (st.counts >= hi) & (st.bdepth < cfg.dmax)
    hot[P] = False
    iota = T._iota(P + 1, hot.device)
    split_ids = torch.sort(torch.where(hot, iota, P)).values
    split_ids = split_ids[:policy.max_splits]
    valid = split_ids < P
    # never exhaust the pool from the proactive path: each split takes two
    # rows from the current free pool before its parent is freed
    avail_pairs = (st.free_top + (P - st.nalloc)) // 2
    valid = valid & (torch.cumsum(valid.to(T.I32), 0) <= avail_pairs)
    st, k = T._do_splits(cfg, st, split_ids, valid)
    st.policy_counts[0] += k
    return st


def _merge_candidate(cfg: T.TableConfig, policy: ResizePolicy,
                     st: T.TableState):
    """(parent_prefix, parent_depth, ok) of the best mergeable buddy pair,
    as device scalars: even-prefix buckets, their buddies resolved through
    the directory (O(pool) elementwise work on the incremental counts).

    Priority is deepest-then-coldest, the inverse of split order: clearing
    the deepest level first is what shrinks the logical directory depth."""
    P, B = cfg.pool_size, cfg.bucket_size
    _, lo = policy.thresholds(B)
    is_left = st.live & (st.bdepth > policy.min_depth) & (st.bprefix % 2 == 0)
    is_left[P] = False
    d = st.bdepth
    # the buddy owns the adjacent prefix range: entry of prefix|1 at depth d
    shift = torch.clamp(cfg.dmax - d, min=0)
    e1 = torch.clamp((st.bprefix | 1) << shift, 0, cfg.dcap - 1)
    buddy = st.directory[e1.long()].long()
    combined = st.counts + st.counts[buddy]
    ok = (is_left
          & (buddy != T._iota(P + 1, d.device))
          & (st.bdepth[buddy] == d)
          & ~st.frozen & ~st.frozen[buddy]
          & (st.counts < B) & (st.counts[buddy] < B)
          & (combined <= lo))
    # merge_buddies allocates the parent before freeing the children: skip
    # when the allocator has no row to hand out (never flag error from here)
    ok = ok & ((st.free_top > 0) | (st.nalloc < P))
    stride = 2 * B + 2
    big = (cfg.dmax + 1) * stride
    score = torch.where(ok, (cfg.dmax - d) * stride + combined, big)
    b = torch.argmin(score)
    return st.bprefix[b] >> 1, st.bdepth[b] - 1, score[b] < big


def _policy_merge(cfg: T.TableConfig, policy: ResizePolicy,
                  st: T.TableState) -> T.TableState:
    """Merge up to ``max_merges`` coldest buddy pairs (freeze → merge →
    unfreeze within the transaction: no FROZEN status ever escapes to a
    caller from policy-driven merges)."""
    for _ in range(policy.max_merges):
        prefix, depth, ok = _merge_candidate(cfg, policy, st)
        ok, prefix, depth = torch.stack(
            [ok.to(T.I32), prefix, depth]).tolist()     # one host read
        if not ok:
            break
        st, merged = T.merge_buddies(cfg, st, prefix, depth)
        st.policy_counts[1] += merged.to(T.I32)
    return st


def apply_policy(cfg: T.TableConfig, policy: ResizePolicy,
                 st: T.TableState) -> T.TableState:
    """One bounded maintenance round: proactive splits, then buddy merges.
    Runs after a combining transaction; ``st`` is consumed."""
    if policy.max_splits > 0:
        st = _policy_split(cfg, policy, st)
    if policy.max_merges > 0:
        st = _policy_merge(cfg, policy, st)
    return st


def resize_pressure(cfg: T.TableConfig, policy: ResizePolicy,
                    st: T.TableState) -> torch.Tensor:
    """Imminent split/merge work as a fraction of live buckets (f32 scalar
    in [0, 1]), the serving tier's backpressure signal.

    A bucket contributes when it is *split-imminent* (live, unfrozen,
    within one item of the high watermark and still deepenable) or
    *merge-eligible* (live, above ``min_depth``, at or below half the low
    watermark). Elementwise over the state, so on a sharded table's
    stacked state the fraction is taken over all shards' live buckets."""
    hi, lo = policy.thresholds(cfg.bucket_size)
    live = st.live            # trash row P is never live, so it drops out
    split_near = (live & ~st.frozen & (st.counts >= hi - 1)
                  & (st.bdepth < cfg.dmax))
    merge_near = live & (st.bdepth > policy.min_depth) & (st.counts <= lo // 2)
    n_live = torch.clamp(live.sum(), min=1)
    n_near = (split_near | merge_near).sum()
    return n_near.to(torch.float32) / n_live.to(torch.float32)


def wrap_apply_fn(policy: ResizePolicy, apply_fn):
    """Compose :func:`apply_policy` onto a combining transaction
    ``apply_fn(cfg, state, ops) -> (state, result)`` (the facade's single
    wiring point; for sharded placement ``core/dist.py`` calls it per
    shard, with the per-shard config, so each shard resizes its own
    key-space region)."""

    def apply_with_policy(cfg, state, ops):
        state, res = apply_fn(cfg, state, ops)
        return apply_policy(cfg, policy, state), res

    return apply_with_policy
