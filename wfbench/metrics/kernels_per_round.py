"""Device kernels per round launched inside the lookup and write calls,
every kernel counted (PyTorch's and the port's), from torch.profiler."""


def read(ctx):
    kernels = ctx["profile"].get("kernels")
    if not kernels or not ctx["rounds_a"]:
        return None
    return sum(kernels.values()) / ctx["rounds_a"]
