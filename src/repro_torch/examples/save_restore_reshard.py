"""Durable images + elastic re-shard: local table → 8-way sharded table.

Builds a local table, saves it to a canonical on-disk image, then restores
that image as an 8-shard table — every bucket re-routes through the
ordinary directory math, no migration code. Sizes and a sample of lookups
are parity-checked against the original. The port of
``examples/save_restore_reshard.py``: the same tables, keys and checks;
the port's sharded placement keeps all 8 shards on the one device, where
the JAX example spreads them over 8 fake host devices.

Run: PYTHONPATH=src python -m repro_torch.examples.save_restore_reshard \
[--device cpu]
"""
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.invariants import check_invariants
from repro_torch.core.table import TableState
from repro_torch.examples import device_args
from repro_torch.table_api import Table, TableSpec


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    # --- build local: 12 directory bits, ~1500 items -----------------------
    local_spec = TableSpec(dmax=12, bucket_size=8, pool_size=1024,
                           n_lanes=16)
    t = Table.create(local_spec, dev)
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 30), size=1500,
                      replace=False).astype(np.int32)
    t, res = t.insert(keys, keys * 7)
    assert not bool(res.error)
    t, _ = t.delete(keys[:250])
    print(f"local:    size={int(t.size()):>5} depth={int(t.depth())} "
          f"placement={t.spec.placement}")

    with tempfile.TemporaryDirectory() as td:
        path = t.save(os.path.join(td, "table.npz"))
        print(f"image:    {os.path.getsize(path)} bytes at {path}")

        # --- restore sharded: 8 shards consume 3 hash bits, so per-shard
        # dmax=9 gives the same 12-bit aggregate addressing ----------------
        sharded_spec = TableSpec(dmax=9, bucket_size=8, pool_size=256,
                                 n_lanes=16, placement="sharded",
                                 shard_bits=3)
        t8 = Table.restore(path, sharded_spec, dev)

    print(f"sharded:  size={int(t8.size()):>5} depth={int(t8.depth())} "
          f"shards={t8.spec.n_shards} device={t8.device}")
    assert int(t8.size()) == int(t.size())

    # parity on a sample: deleted keys miss, live keys carry their values
    sample = np.concatenate([keys[:50], keys[700:750]])
    f_lo, v_lo = (x.cpu().numpy() for x in t.lookup(sample))
    f_sh, v_sh = (x.cpu().numpy() for x in t8.lookup(sample))
    assert (f_lo == f_sh).all()
    assert (v_lo == v_sh).all()
    assert not f_sh[:50].any() and f_sh[50:].all()

    # the revived table is a first-class citizen: transactions keep working
    t8, res = t8.insert(keys[:250], keys[:250] * 7)
    assert bool((res.status == 1).all())    # all fresh re-inserts
    assert int(t8.size()) == len(keys)

    # every shard of the revived-and-refilled table passes the structural
    # invariants (the per-shard config carries the shard id's hash_shift)
    lcfg = t8.spec.table_config()
    for s in range(t8.spec.n_shards):
        check_invariants(lcfg, TableState(*[x[s] for x in t8.state]))
    print(f"refilled: size={int(t8.size()):>5} — "
          "local → image → 8-way sharded, content-identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
