"""Share of the host-timed rounds' write transactions (one per
``n_lanes`` chunk of a write call) that entered the slow path."""


def read(ctx):
    if not ctx["txns_b"]:
        return None
    return 100.0 * ctx["slow_calls_b"] / ctx["txns_b"]
