"""Share of the host-timed rounds' wall spent in the slow path: every
``core/table.py::apply_batch`` call (the ``ST_FULL`` re-entry), bracketed
by ``torch.cuda.synchronize()``, over the wall of those rounds."""


def read(ctx):
    if not ctx["rounds_b"] or ctx["wall_b_s"] <= 0:
        return None
    return 100.0 * ctx["slow_s_b"] / ctx["wall_b_s"]
