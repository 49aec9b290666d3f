"""One minus the union of device activity (kernels, copies, fills) over
the profiled window, from torch.profiler."""


def read(ctx):
    prof = ctx["profile"]
    if not prof.get("window_us"):
        return None
    return 100.0 * (1.0 - prof["busy_us"] / prof["window_us"])
