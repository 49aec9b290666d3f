"""The lookup calls' share of the HBM roofline: the bytes the profiled
rounds' lookups need (``peaks.lookup_bytes``) over 3.35 TB/s, divided by
the device time of every kernel that ran inside the lookup spans."""
from wfbench.peaks import PEAK_BYTES_S


def read(ctx):
    us = ctx["profile"].get("span_device_us", {}).get("lookup", 0.0)
    if not us or ctx["lookup_bytes_a"] is None:
        return None
    return 100.0 * ctx["lookup_bytes_a"] / PEAK_BYTES_S / (us / 1e6)
