"""Structural invariants of the extendible hash table, checked on the host.

The properties the paper's correctness argument rests on, as numpy checks
over :func:`repro_torch.core.table.to_numpy` of a state (or the state
itself). Every check is vectorized over buckets, so a full-size table
(2**20 directory entries, ~10**5 live buckets) checks in about a second.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import EMPTY_KEY, HASH_BITS, hash_np
from repro_torch.core.table import TableConfig, TableState, to_numpy


def _as_numpy(state) -> dict:
    return to_numpy(state) if isinstance(state, TableState) else state


def _shards(s: dict) -> list:
    """The per-shard dicts of a stacked state, or ``[s]`` for a local
    one (a local directory is 1-d)."""
    if s["directory"].ndim == 1:
        return [s]
    return [{k: v[j] for k, v in s.items()}
            for j in range(s["directory"].shape[0])]


def check_invariants(cfg: TableConfig, state, allow_error: bool = False):
    """Raises AssertionError with a descriptive message on violation.

    ``allow_error=True`` admits states whose error flag was set by a
    legitimate capacity/depth exhaustion; the structural invariants must
    hold regardless. A stacked sharded state is checked per shard: a mesh
    table's ``state`` (its local shards), or :func:`full_view` (all)."""
    for s in _shards(_as_numpy(state)):
        _check_local(cfg, s, allow_error)


def _check_local(cfg: TableConfig, s: dict, allow_error: bool) -> None:
    P, B = cfg.pool_size, cfg.bucket_size
    d = s["directory"].astype(np.int64)
    keys, live = s["keys"], s["live"]
    bdepth = s["bdepth"].astype(np.int64)
    bprefix = s["bprefix"].astype(np.int64)
    if not allow_error:
        assert not bool(s["error"]), "table error flag set"

    # 1. directory entries point at live buckets owning their prefix range
    assert d.min() >= 0 and d.max() < P, "directory out of pool range"
    assert live[d].all(), "directory entry points at a dead bucket"
    e = np.arange(cfg.dcap)
    assert ((e >> (cfg.dmax - bdepth[d])) == bprefix[d]).all(), \
        "directory entry not covered by its bucket's prefix"
    # each referenced bucket owns its FULL range: every entry pointing at
    # it lies in its range (above), and there are 2**(dmax - depth) of them
    owners, n_entries = np.unique(d, return_counts=True)
    assert (n_entries == 1 << (cfg.dmax - bdepth[owners])).all(), \
        "bucket range not contiguous"
    # every live bucket is reachable
    assert np.array_equal(owners, np.nonzero(live[:P])[0]), \
        "live set != directory-reachable set"

    # 2. items hash into their bucket; no intra-bucket duplicates
    rows = keys[owners]
    occ = rows != EMPTY_KEY
    srt = np.sort(rows, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != EMPTY_KEY)
    assert not dup.any(), \
        f"duplicate key in bucket {owners[dup.any(axis=1)][0]}"
    r, c = np.nonzero(occ)
    if r.size:
        h = hash_np(cfg.hash_name, rows[r, c], cfg.hash_shift).astype(
            np.int64)
        dep = bdepth[owners[r]]
        pref = np.where(dep > 0, h >> (HASH_BITS - np.maximum(dep, 1)), 0)
        bad = pref != bprefix[owners[r]]
        assert not bad.any(), f"key in wrong bucket {owners[r][bad][0]}"

    # 3. depth scalar == max live bucket depth
    assert int(s["depth"]) == int(bdepth[live].max() if live[:P].any()
                                  else 0), "depth scalar out of sync"

    # 4. bucket depths never exceed the directory capacity
    assert (bdepth[live] <= cfg.dmax).all()

    # 5. incremental occupancy counts match a recount on every live
    # bucket, and the trash row stays 0
    counts = s["counts"]
    occ_re = (keys != EMPTY_KEY).sum(axis=-1)
    assert (counts[live] == occ_re[live]).all(), \
        "incremental counts out of sync with pool occupancy"
    assert counts[P] == 0, "trash-row count nonzero"

    # 5b. policy action counters: non-negative (splits, merges)
    pc = s["policy_counts"]
    assert pc.shape == (2,) and (pc >= 0).all(), \
        f"policy_counts malformed: {pc}"

    # 6. allocator consistency: live ∩ free = ∅, live ∪ free ⊆ [0, nalloc)
    free = s["free_stack"][: int(s["free_top"])]
    live_ids = np.nonzero(live[:P])[0]
    assert not np.isin(free, live_ids).any(), "freed bucket still live"
    if len(free):
        assert free.max() < int(s["nalloc"])
    assert live_ids.max(initial=-1) < int(s["nalloc"])


def full_view(table) -> dict:
    """The whole state of a ``Table`` handle as numpy arrays: a mesh
    table's local shards gathered over its ``model`` group into the full
    ``[n_shards]`` stack (every rank of the mesh calls this), any other
    table's own state. :func:`check_invariants` and :func:`to_dict` take
    it like a state; a mesh table's ``state`` alone gives its local
    shards."""
    if table.mesh is None:
        return to_numpy(table.state)
    from repro_torch.core.dist import gather_shards
    full = gather_shards(table.spec.dist_config(), table.state, table.mesh)
    return to_numpy(TableState(**full))


def to_dict(cfg: TableConfig, state) -> dict:
    """Materialize the table's key→value map (test-side view); for a
    stacked sharded state, the union of the shards' maps."""
    out = {}
    for s in _shards(_as_numpy(state)):
        rows = np.nonzero(s["live"][: cfg.pool_size])[0]
        keys, vals = s["keys"][rows], s["vals"][rows]
        occ = keys != EMPTY_KEY
        out.update(zip(keys[occ].tolist(), vals[occ].tolist()))
    return out
