"""The control: the plain reference put in the program's place, with one of
the configuration's guarantees broken.

``ControlTable`` answers the facade calls the benchmark makes
(``lookup``, ``apply``, ``update``, ``size``) from a Python dict, op by op
in lane order, except that a lookup sees the map as it stood before the
previous write call: reads one call stale, the step a pipelined write
path would tempt. The guarantee it breaks is "a lookup sees every call
issued before it". A run with it in the program's place has to come out
not correct.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NOP, INS, DEL = 0, 1, 2


class Result(NamedTuple):
    status: torch.Tensor
    error: torch.Tensor


class ControlTable:
    """Dict-backed stand-in for ``Table``: raw int32 values, or payload
    rows of uint8 ``fields`` (``[(name, shape)]``) in an append-only list
    on the host."""

    def __init__(self, device, fields=None):
        self.device = torch.device(device)
        self.fields = fields
        self.d, self.stale = {}, {}
        self.rows = []          # payload rows, appended, never rewritten
        self.record = (sum(int(np.prod(s)) for _, s in fields)
                       if fields else 0)

    # -- the facade calls ----------------------------------------------

    def lookup(self, keys):
        ks = keys.cpu().numpy().tolist()
        got = [self.stale.get(k) for k in ks]
        found = np.array([g is not None for g in got])
        dev = self.device
        if self.fields is None:
            vals = np.array([-1 if g is None else g for g in got], np.int32)
            return (torch.tensor(found, device=dev),
                    torch.tensor(vals, device=dev))
        rows = np.zeros((len(ks), self.record), np.uint8)
        hit = np.nonzero(found)[0]
        if hit.size:
            rows[hit] = np.stack([self.rows[got[i]] for i in hit])
        return torch.tensor(found, device=dev), self._fields_of(rows)

    def apply(self, kinds, keys, values=None):
        self.stale = dict(self.d)
        ks = keys.cpu().numpy().tolist()
        kinds = kinds.cpu().numpy().tolist()
        vals = self._host_values(len(ks), values)
        status = np.zeros(len(ks), np.int8)
        for i, (c, k) in enumerate(zip(kinds, ks)):
            if c == INS:
                status[i] = k not in self.d
                self.d[k] = self._store(vals, i)
            elif c == DEL:
                status[i] = k in self.d
                self.d.pop(k, None)
        return self, self._result(status)

    def insert(self, keys, values=None):
        kinds = torch.full((keys.numel(),), INS, dtype=torch.int32)
        return self.apply(kinds, keys, values)

    def update(self, keys, values=None):
        present = [k in self.d for k in keys.cpu().numpy().tolist()]
        kinds = torch.tensor(np.where(present, INS, NOP).astype(np.int32))
        t, res = self.apply(kinds, keys, values)
        return t, self._result(np.zeros(len(present), np.int8))

    def size(self):
        return torch.tensor(len(self.d))

    # -- helpers ----------------------------------------------------------

    def _result(self, status):
        return Result(status=torch.tensor(status, device=self.device),
                      error=torch.tensor(False, device=self.device))

    def _host_values(self, m, values):
        if values is None:
            return None
        if self.fields is None:
            return values.cpu().numpy().astype(np.int64)
        return np.concatenate(
            [values[name].cpu().reshape(m, -1).numpy()
             for name, _ in self.fields], axis=1)

    def _store(self, vals, i):
        if self.fields is None:
            return 0 if vals is None else int(vals[i])
        self.rows.append(vals[i].copy())
        return len(self.rows) - 1

    def _fields_of(self, rows):
        out, at = {}, 0
        t = torch.tensor(rows, device=self.device)
        for name, shape in self.fields:
            size = int(np.prod(shape))
            out[name] = t[:, at:at + size].reshape((rows.shape[0],)
                                                   + tuple(shape))
            at += size
        return out
