"""Self-check of the sharded table, through the ``Table`` facade.

    python -m repro_torch.core.dist_check [--device cpu|cuda]

The port of the table half of ``repro/core/dist_check.py``. For 2 and 4
shards, a random batched workload runs through a sharded ``Table``; every
status must equal, lane for lane, (a) a local ``Table`` over the same
aggregate hash bits and (b) the paper-literal sequential reference
(``core/reference.py::SeqExtHash``); every lookup must agree with both,
the invariants must hold per shard, and the final content (the union of
the shards' maps) must equal both. Exit code 0 = pass.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import table as T
from repro_torch.core.invariants import check_invariants, to_dict
from repro_torch.core.reference import SeqExtHash
from repro_torch.core.spec import TableSpec

N_LANES = 16
STEPS = 12


def check_shards(shard_bits: int, device: str, seed: int = 0) -> int:
    """Run the workload on a ``2**shard_bits``-shard table; returns the
    final item count (raises AssertionError on any disagreement)."""
    from repro_torch.table_api import Table

    # each shard a dmax=8 WF-Ext; the local table and the reference see
    # the same aggregate addressing, dmax + shard_bits hash bits
    sh_spec = TableSpec(dmax=8, bucket_size=4, pool_size=256,
                        n_lanes=N_LANES, placement="sharded",
                        shard_bits=shard_bits)
    bits = 8 + shard_bits
    lo_spec = TableSpec(dmax=bits, bucket_size=4, pool_size=256 << shard_bits,
                        n_lanes=N_LANES)
    t_sh = Table.create(sh_spec, device)
    t_lo = Table.create(lo_spec, device)
    ref = SeqExtHash(dmax=bits, bucket_size=4)
    rng = np.random.default_rng(seed)
    for step in range(STEPS):
        kinds = rng.integers(1, 3, size=N_LANES).astype(np.int32)
        # distinct keys per batch: shard-local linearization order can
        # differ from the reference's lane order for same-key conflicts
        keys = rng.choice(np.arange(1, 4000), size=N_LANES,
                          replace=False).astype(np.int32)
        vals = rng.integers(0, 999, size=N_LANES).astype(np.int32)
        t_sh, res_sh = t_sh.apply(kinds, keys, vals)
        t_lo, res_lo = t_lo.apply(kinds, keys, vals)
        want = [ref.insert(int(k), int(v)) if c == T.INS
                else ref.delete(int(k))
                for c, k, v in zip(kinds, keys, vals)]
        assert res_sh.status.tolist() == want, (step, res_sh.status, want)
        assert res_lo.status.tolist() == want, (step, res_lo.status, want)
        assert not bool(res_sh.error) and not bool(res_lo.error), step

        q = rng.choice(np.arange(1, 4000), size=N_LANES).astype(np.int32)
        f1, v1 = t_sh.lookup(q)
        f2, v2 = t_lo.lookup(q)
        want_fv = [ref.lookup(int(k)) for k in q]
        assert f1.tolist() == f2.tolist() == [f for f, _ in want_fv], step
        assert v1.tolist() == v2.tolist() == [v for _, v in want_fv], step

    check_invariants(sh_spec.table_config(), t_sh.state)
    got = to_dict(sh_spec.table_config(), t_sh.state)
    lo_map = to_dict(lo_spec.table_config(), t_lo.state)
    ref_map = ref.as_dict()
    assert got == lo_map == ref_map, (len(got), len(lo_map), len(ref_map))
    assert int(t_sh.size()) == len(ref_map)
    return len(got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    for shard_bits in (1, 2):
        n = check_shards(shard_bits, args.device)
        print(f"dist table OK: {n} items across {1 << shard_bits} shards, "
              f"{STEPS} transactions, statuses lane-exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
