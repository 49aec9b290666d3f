"""The 95th percentile of the host-timed rounds' times (host clock, from a
round's first call until its results are on the host): the round tail,
read in the traced run because its spread between runs is too wide for a
bound on the end-to-end metric."""
import statistics


def read(ctx):
    times = ctx["round_s_b"]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[-1] * 1e3
