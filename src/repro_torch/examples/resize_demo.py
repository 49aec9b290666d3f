"""Watch the extendible directory grow: splits + logical doubling.

The port of ``examples/resize_demo.py``: the same table, keys and growth
table.

Run: PYTHONPATH=src python -m repro_torch.examples.resize_demo [--device cpu]
"""
import numpy as np
import torch

from repro_torch.core.invariants import check_invariants
from repro_torch.examples import device_args
from repro_torch.table_api import Table, TableSpec


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    spec = TableSpec(dmax=12, bucket_size=4, pool_size=4096, n_lanes=64,
                     initial_depth=1)
    t = Table.create(spec, dev)
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 30), size=2048, replace=False)

    print(f"{'inserted':>9} {'depth':>6} {'buckets':>8} {'load':>6}")
    for i in range(0, len(keys), 4 * spec.n_lanes):
        chunk = keys[i:i + 4 * spec.n_lanes].astype(np.int32)  # 4 txns
        t, res = t.insert(chunk, chunk)
        assert not bool(res.error)
        n_items = int(t.size())
        n_buckets = int(t.state.live.sum())
        print(f"{i + len(chunk):>9} {int(t.state.depth):>6} "
              f"{n_buckets:>8} "
              f"{n_items / (n_buckets * spec.bucket_size):>6.2f}")
    check_invariants(t.config, t.state)
    assert int(t.state.depth) == 12
    print("done: wait-free growth from 2 buckets to depth",
          int(t.state.depth))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
