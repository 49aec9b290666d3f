"""Serving-tier request router (see ``router.py`` for the design).

Public surface::

    from repro_torch.serving.router import Router, RouterConfig, READ, INS, DEL

    r = Router(table, RouterConfig(max_batch=64, max_delay_s=2e-3))
    req, decision = r.submit(INS, key=7, value=70)
    done = r.pump()            # dispatches when the batcher says so
    r.handover(new_spec)       # rolling upgrade, zero dropped requests
    print(r.report())

The same names as the JAX package's ``repro.serving.router``. Exports
resolve lazily (PEP 562): importing the package imports nothing else.
"""

_EXPORTS = {
    "Router": "router",
    "RouterConfig": "router",
    "Request": "queue",
    "ShardQueues": "queue",
    "shard_of": "queue",
    "NOP": "queue",
    "INS": "queue",
    "DEL": "queue",
    "READ": "queue",
    "ADMITTED": "queue",
    "SHED_QUEUE_FULL": "queue",
    "SHED_PRESSURE": "queue",
    "CostModel": "costmodel",
    "measure_cost_model": "costmodel",
    "cost_model_for": "costmodel",
    "default_cost_model": "costmodel",
    "LatencyHistogram": "metrics",
    "RouterMetrics": "metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(
            f"repro_torch.serving.router.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'repro_torch.serving.router' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
