"""Serving tier in one screen: router, admission control, rolling upgrade.

Builds a policy-active table behind a request Router, measures the
dispatch cost model on the live backend (that is what sizes the adaptive
batches), serves a closed-loop multi-client workload with differential
parity against the sequential oracle, then upgrades the table to a
bigger spec MID-TRAFFIC — queued requests ride through the handover and
the run asserts zero were dropped. The port of
``examples/serving_router.py``: the same specs, router settings, requests
and prints.

Run: PYTHONPATH=src python -m repro_torch.examples.serving_router \
[--device cpu]
"""
import torch

from repro_torch.core.policy import ResizePolicy
from repro_torch.examples import device_args
from repro_torch.serving.router import (INS, READ, Router, RouterConfig,
                                        cost_model_for)
from repro_torch.table_api import Table, TableSpec
from repro_torch.workloads import serve_closed_loop


def main(argv=None):
    dev = torch.device(device_args(__doc__, argv).device)
    # --- a policy-active table behind a router -----------------------------
    spec = TableSpec(dmax=10, bucket_size=8, pool_size=1024, n_lanes=16,
                     resize_policy=ResizePolicy())
    table = Table.create(spec, dev)
    model = cost_model_for(table)     # measured on THIS (device, plan)
    print(f"cost model: base={model.base_s*1e3:.3f}ms "
          f"chunk={model.chunk_s*1e3:.3f}ms/{model.n_lanes}lanes")

    router = Router(table, RouterConfig(max_batch=64, max_delay_s=2e-3,
                                        slo_p50_ms=25.0, slo_p99_ms=250.0))
    router.warmup()
    print(f"adaptive batch floor: {router.batch_floor} ops "
          f"(amortizes {model.base_s*1e3:.2f}ms of fixed dispatch "
          "overhead)")

    # --- individual requests in, batched transactions out ------------------
    for k in range(1, 40):
        router.submit(INS, k, k * 100)
    router.submit(READ, 7)
    done = router.flush()
    read = [r for r in done if r.kind == READ][0]
    print(f"burst of {len(done)} requests -> "
          f"{router.metrics.dispatches} batched dispatches; "
          f"lookup(7) = ({read.found}, {read.result})")
    assert (read.found, read.result) == (True, 700)

    # --- closed-loop serving with parity + a mid-traffic upgrade -----------
    bigger = TableSpec(dmax=11, bucket_size=8, pool_size=2048, n_lanes=16,
                       resize_policy=ResizePolicy())
    report = serve_closed_loop(
        spec, n_clients=8, ops_per_client=60, device=dev, mix="churn",
        seed=0, cost_model=model,
        router_config=RouterConfig(max_batch=64, max_delay_s=2e-3),
        handover_at=0.5, handover_spec=bigger)

    tot = report["total"]
    print(f"closed loop: {report['completed']} requests from "
          f"{report['n_clients']} clients, mean batch "
          f"{report['mean_batch']}, p50={tot['p50_ms']:.2f}ms "
          f"p99={tot['p99_ms']:.2f}ms")
    print(f"upgrade mid-traffic: handovers={report['handovers']} "
          f"dropped={report['dropped']} "
          f"parity mismatches={report['status_mismatches']}"
          f"+{report['content_mismatches']}")
    assert report["ok"]
    print("serving router example OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
