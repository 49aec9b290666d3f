"""The write calls' share of the HBM roofline: the bytes the profiled
rounds' writes need (``peaks.apply_bytes``) over 3.35 TB/s, divided by the
device time of every kernel that ran inside the write spans."""
from wfbench.peaks import PEAK_BYTES_S


def read(ctx):
    us = ctx["profile"].get("span_device_us", {}).get("write", 0.0)
    if not us or ctx["apply_bytes_a"] is None:
        return None
    return 100.0 * ctx["apply_bytes_a"] / PEAK_BYTES_S / (us / 1e6)
