"""Watch the directory breathe: the elastic ResizePolicy round trip.

Fills the table (watermark splits grow the directory *before* buckets
overflow), drains it (buddy merges — the paper's §4.5 shrink path — pull
the directory back down), then refills. The depth column rises, falls,
and rises again; the splits/merges columns show the policy doing it. The
port of ``examples/elastic_churn.py``: the same policy, keys and prints.

Run: PYTHONPATH=src python -m repro_torch.examples.elastic_churn \
[--device cpu]
"""
import numpy as np
import torch

from repro_torch.core.invariants import check_invariants
from repro_torch.examples import device_args
from repro_torch.table_api import ResizePolicy, Table, TableSpec


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    policy = ResizePolicy(split_watermark=0.75, merge_watermark=0.375,
                          max_splits=8, max_merges=4)
    spec = TableSpec(dmax=10, bucket_size=8, pool_size=1024, n_lanes=32,
                     resize_policy=policy)
    t = Table.create(spec, dev)
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 30), size=1500, replace=False)
    keys = keys.astype(np.int32)
    nop = np.zeros(spec.n_lanes, np.int32)

    def report(label):
        s = t.policy_stats()
        print(f"{label:>10} depth={int(t.depth()):>2} "
              f"size={int(t.size()):>5} "
              f"auto-splits={int(s['splits']):>4} "
              f"auto-merges={int(s['merges']):>4}")

    print(f"{'phase':>10} {'':>0}")
    for lo in range(0, len(keys), 5 * spec.n_lanes):
        chunk = keys[lo:lo + 5 * spec.n_lanes]
        t, res = t.insert(chunk, chunk)
        assert not bool(res.error)
    report("fill")

    t, _ = t.delete(keys[:1400])                  # drain 93%
    report("drain")

    for _ in range(40):                           # read-only traffic: the
        t, _ = t.apply(nop, nop)                  # policy keeps merging
    report("maintain")

    t, _ = t.insert(keys[:700], keys[:700])       # refill: growth resumes
    report("refill")

    check_invariants(t.config, t.state)
    stats = t.policy_stats()
    assert int(stats["splits"]) > 0 and int(stats["merges"]) > 0
    print("done: the directory grew, shrank, and grew again — elastically")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
