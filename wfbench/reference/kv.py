"""The plain reference: a key-value map with the table's stated semantics.

State is two arrays over the key-space indices the benchmark hands both
sides with the keys (universe index or record number): ``present`` and
``value`` (the raw word, or the version of the payload last written). It
holds the configuration's guarantees and nothing of the program:

* each op once, in lane order within a call and in call order across
  calls: an insert reports TRUE iff its key was absent at its turn, a
  delete TRUE iff present; the last op on a key decides its state;
* an update (``Table.update``) writes only keys present before the call
  and reports FALSE on every lane (an insert over a present key);
* a lookup sees every call issued before it.

NumPy only: it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

NOP, INS, DEL = 0, 1, 2


class KVReference:
    """Lane-order key-value map over integer indices (grows on demand)."""

    def __init__(self, size: int = 1 << 16):
        self.present = np.zeros(size, bool)
        self.value = np.zeros(size, np.int64)

    def _fit(self, idx: np.ndarray) -> None:
        top = int(idx.max()) + 1 if idx.size else 0
        if top > self.present.size:
            n = max(top, 2 * self.present.size)
            self.present = np.r_[self.present,
                                 np.zeros(n - self.present.size, bool)]
            self.value = np.r_[self.value,
                               np.zeros(n - self.value.size, np.int64)]

    def load(self, idx: np.ndarray, values: np.ndarray) -> None:
        self._fit(idx)
        self.present[idx] = True
        self.value[idx] = values

    def lookup(self, idx: np.ndarray):
        """(found bool[m], value int64[m]; -1 where absent)."""
        self._fit(idx)
        found = self.present[idx]
        return found, np.where(found, self.value[idx], -1)

    def apply(self, kinds: np.ndarray, idx: np.ndarray,
              values: np.ndarray) -> np.ndarray:
        """One call of INS/DEL ops (NOP lanes report FALSE and do
        nothing). Returns the int8 statuses."""
        self._fit(idx)
        n = kinds.size
        status = np.zeros(n, np.int8)
        act = np.nonzero(kinds != NOP)[0]
        if act.size == 0:
            return status
        order = act[np.lexsort((act, idx[act]))]
        si, sk, sv = idx[order], kinds[order], values[order]
        first = np.r_[True, si[1:] != si[:-1]]
        last = np.r_[si[1:] != si[:-1], True]
        before = np.where(first, self.present[si],
                          np.r_[False, sk[:-1] == INS])
        status[order] = np.where(sk == INS, ~before, before)
        li = si[last]
        self.present[li] = sk[last] == INS
        self.value[li] = np.where(sk[last] == INS, sv[last], self.value[li])
        return status

    def update(self, idx: np.ndarray, values: np.ndarray) -> np.ndarray:
        """``Table.update``: presence read before the call; present keys
        are upserted in lane order; every lane reports FALSE."""
        self._fit(idx)
        kinds = np.where(self.present[idx], INS, NOP)
        self.apply(kinds, idx, values)
        return np.zeros(idx.size, np.int8)

    def live(self) -> np.ndarray:
        return np.nonzero(self.present)[0]
