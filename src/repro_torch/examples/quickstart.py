"""Quickstart: the wait-free extendible hash table in five minutes.

One typed handle — `Table` — over every backend and placement; batches of
any length; values that can be a dict of typed fields, not just an i32.
The port of ``examples/quickstart.py``: the same table, ops and prints.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import torch

from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.examples import device_args
from repro_torch.table_api import Table, TableSpec


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    # a table with 2^10 max directory entries, 8-slot buckets, 16 op lanes
    spec = TableSpec(dmax=10, bucket_size=8, pool_size=1024, n_lanes=16)
    t = Table.create(spec, dev)

    # wait-free combining transactions: the batch announces its ops, the
    # batched combiner applies them all (splitting buckets as needed). Any
    # batch length works — 21 ops become two NOP-padded 16-lane
    # transactions.
    keys = torch.arange(100, 121, dtype=torch.int32, device=dev)
    t, res = t.insert(keys, keys * 7)
    print("insert statuses:", res.status.cpu().numpy())   # all 1 = fresh
    assert bool((res.status == 1).all())

    # rule-A lookups: pure gathers, zero synchronization
    found, got = t.lookup([100, 115, 999])
    print("lookup:", found.cpu().numpy(), got.cpu().numpy())

    # deletes; mixed batches go through t.apply(kinds, keys, values)
    t, res = t.delete(keys)
    print("delete statuses:", res.status.cpu().numpy())   # all 1 = present
    assert bool((res.status == 1).all())

    check_invariants(t.config, t.state)
    print("size after deletes:", int(t.size()))
    assert int(t.size()) == 0

    # --- typed value schemas: payloads beyond one i32 ----------------------
    spec = TableSpec(dmax=10, n_lanes=16,
                     value_schema={"owner": torch.int32,
                                   "weight": (torch.float32, ())})
    t = Table.create(spec, dev)
    t, _ = t.insert([7, 8, 9], {"owner": [70, 80, 90],
                                "weight": [0.7, 0.8, 0.9]})
    found, payload = t.lookup([7, 9, 11])
    print("schema lookup:", found.cpu().numpy(),
          payload["owner"].cpu().numpy(), payload["weight"].cpu().numpy())
    check_invariants(t.config, t.state)
    print("final content (raw handles):", to_dict(t.config, t.state))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
