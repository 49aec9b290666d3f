"""The plain reference against a brute-force dict, op by op, at a tiny
size with repeated keys inside a call."""
import numpy as np
import pytest

from wfbench.reference import KVReference

NOP, INS, DEL = 0, 1, 2


def brute_apply(d, kinds, idx, vals):
    status = []
    for c, k, v in zip(kinds.tolist(), idx.tolist(), vals.tolist()):
        if c == INS:
            status.append(int(k not in d))
            d[k] = v
        elif c == DEL:
            status.append(int(k in d))
            d.pop(k, None)
        else:
            status.append(0)
    return np.array(status, np.int8)


@pytest.mark.parametrize("seed", range(4))
def test_reference_equals_a_dict(seed):
    rng = np.random.default_rng(seed)
    ref, d = KVReference(size=8), {}
    pre = rng.choice(64, 20, replace=False)
    ref.load(pre, pre * 10)
    d.update({int(k): int(k) * 10 for k in pre})
    for _ in range(50):
        n = int(rng.integers(1, 40))
        kinds = rng.integers(0, 3, n)
        idx = rng.integers(0, 80, n)          # repeats, and past the size
        vals = rng.integers(0, 1000, n)
        q = rng.integers(0, 80, 30)
        found, got = ref.lookup(q)
        assert found.tolist() == [int(k) in d for k in q]
        assert got.tolist() == [d.get(int(k), -1) for k in q]
        assert np.array_equal(ref.apply(kinds, idx, vals),
                              brute_apply(d, kinds, idx, vals))
        upd = rng.integers(0, 80, 10)
        uv = rng.integers(0, 1000, 10)
        present = np.array([int(k) in d for k in upd])
        brute_apply(d, np.where(present, INS, NOP), upd, uv)
        assert not ref.update(upd, uv).any()
    assert sorted(ref.live().tolist()) == sorted(d)
    assert [int(ref.value[k]) for k in sorted(d)] == [d[k] for k in sorted(d)]
