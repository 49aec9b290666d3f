"""Device milliseconds per round in the payload side store's stages
(``_alloc_handles``, ``_write_payloads``, ``_reconcile_handles``): a pair
of CUDA events around each call, summed over the host-timed rounds. Only a
value schema runs these stages."""


def read(ctx):
    if not ctx["stage_calls_b"] or not ctx["rounds_b"]:
        return None
    return ctx["payload_ms_b"] / ctx["rounds_b"]
