"""Directories deeper than 20 bits (``TableConfig.dmax`` up to 30).

The JAX package stops at 20 bits; the port goes to 30, and is held here
to its own sequential oracle (``core/reference.py``): with the identity
hash, keys that share their top 20 bits split past depth 20 at dmax 21
and 22, lane for lane and item for item as the oracle, with every
invariant; the same keys at dmax 20 end in ``OVERFLOW``. Splits and
merges rewrite only the parent's directory range, never all 2**dmax
entries. The spec's range checks raise ``ValueError`` without building a
table.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.reference import SeqExtHash
from repro_torch.table_api import Table, TableSpec

PREFIX = 0x5A3C1        # the 20 hash bits every key shares (identity hash)
INITIAL_DEPTH = 8
N_LANES = 16


def deep_keys(dmax: int) -> np.ndarray:
    """Keys under one 20-bit prefix that need exactly ``dmax`` bits, and
    leave no bucket full (a full bucket at depth dmax refuses every op):
    at 21, 7 and 7 keys on bit 21; at 22, 10 keys on bit 21's 0 side (5
    and 5 on bit 22) and 4 on its 1 side. The low 10 bits are seeded."""
    sides = {21: [(0, 0)] * 4 + [(0, 1)] * 3 + [(1, 0)] * 4 + [(1, 1)] * 3,
             22: [(0, 0)] * 5 + [(0, 1)] * 5 + [(1, 0)] * 2 + [(1, 1)] * 2}
    b21, b22 = np.array(sides[dmax]).T
    low = np.random.default_rng(dmax).choice(1 << 10, size=b21.size,
                                             replace=False)
    keys = (PREFIX << 12) | (b21 << 11) | (b22 << 10) | low
    return np.random.default_rng(dmax + 1).permutation(keys).astype(np.int32)


def run(dmax: int, keys: np.ndarray, backend: str, during=None):
    """A load of ``keys`` in one transaction, then a delete of every third
    and a re-insert of the first four in a second (both inside the context
    ``during``, if given); statuses of both, and the oracle's, op by op in
    lane order."""
    spec = TableSpec(dmax=dmax, bucket_size=8,
                     pool_size=(1 << INITIAL_DEPTH) + 64, n_lanes=N_LANES,
                     initial_depth=INITIAL_DEPTH, hash_name="identity",
                     backend=backend)
    t = Table.create(spec, device="cpu")
    oracle = SeqExtHash(dmax, 8, INITIAL_DEPTH, hash_name="identity")
    gone = keys[::3]
    again = keys[:4]
    kinds = np.r_[np.full(gone.size, T.DEL), np.full(again.size, T.INS)]
    batches = [(np.full(keys.size, T.INS), keys),
               (kinds, np.r_[gone, again])]
    got, want = [], []
    for kind, k in batches:
        vals = k ^ 0x77
        with during or contextlib.nullcontext():
            t, res = t.apply(torch.tensor(kind, dtype=torch.int32),
                             torch.tensor(k), torch.tensor(vals))
        got.append(res.status.numpy())
        want.append(np.array([oracle.insert(int(x), int(v)) if op == T.INS
                              else oracle.delete(int(x))
                              for op, x, v in zip(kind, k, vals)]))
    return t, oracle, got, want


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("dmax", [21, 22])
def test_keys_sharing_20_bits_split_past_depth_20(dmax, backend):
    t, oracle, got, want = run(dmax, deep_keys(dmax), backend)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not (np.concatenate(got) == T.OVERFLOW).any()
    check_invariants(t.config, t.state)
    assert to_dict(t.config, t.state) == oracle.as_dict()
    assert int(t.depth()) == oracle.depth == dmax


@pytest.mark.parametrize("dmax", [21, 22])
def test_the_same_keys_overflow_at_dmax_20(dmax):
    t, oracle, got, want = run(20, deep_keys(dmax), "plain")
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[0] == T.OVERFLOW).any() and bool(t.state.error)
    check_invariants(t.config, t.state, allow_error=True)


class LargestNew(TorchDispatchMode):
    """The most elements of any tensor an op makes afresh (views and
    in-place results, which share an input's storage, left out)."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in tree_leaves(
            (args, kwargs)) if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in ins):
                self.numel = max(self.numel, t.numel())
        return out


def test_splits_and_merges_touch_only_the_parents_range():
    """At dmax 23 (8 M entries) the load splits from the initial depth 8
    (parent ranges of 2**15) down to 22, and a merge of two buckets at
    depth 22 rewrites their parent's 4 entries: no op makes a tensor
    within a factor 64 of the directory, the load equals the oracle and
    the merge changes the directory inside the parent's range alone."""
    dmax, keys = 23, deep_keys(22)
    mode = LargestNew()
    t, oracle, got, want = run(dmax, keys, "plain", during=mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(t.depth()) == 22
    t, _ = t.delete(torch.tensor(keys[4:]))     # the buddies now fit one
    st = t.state
    leaf = int(torch.nonzero(st.live & (st.bdepth == 22)
                             & (st.bprefix % 2 == 0))[0])
    prefix = int(st.bprefix[leaf]) >> 1
    before = st.directory.clone()
    with mode:
        t, ok = t.merge(prefix, 21)
    assert bool(ok) and mode.numel < t.config.dcap // 64
    check_invariants(t.config, t.state)
    changed = torch.nonzero(t.state.directory != before).flatten()
    assert changed.numel() and (changed >> (dmax - 21) == prefix).all()
    assert int(t.depth()) == 21          # the one pair at 22 merged


def test_spec_range_checks_raise_value_error():
    cfg = TableSpec(dmax=30, bucket_size=8, pool_size=2**24,
                    n_lanes=4096, initial_depth=23).table_config()
    assert cfg.dcap == 2**30 and cfg.rounds == 32
    sharded = TableSpec(dmax=24, placement="sharded", shard_bits=8)
    assert sharded.table_config().hash_shift == 8
    for bad in (dict(dmax=31), dict(dmax=0),
                dict(dmax=26, placement="sharded", shard_bits=8)):
        with pytest.raises(ValueError, match="dmax"):
            TableSpec(**bad)
    with pytest.raises(ValueError, match="hash_shift"):
        T.TableConfig(dmax=30, hash_shift=3)
