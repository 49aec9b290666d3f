"""The yardstick's fixed numbers: the card's peaks and the bytes each call
needs, counted from the calls' inputs and outputs.

The byte arithmetic is the bound ``chip_smoke.py`` phase 7 computes for
the kernels (``fused_times`` / ``unfused_times`` / ``apply_bytes_needed``),
frozen here and widened from one launch to one facade call: it counts the
work a call has to do, whatever kernels do it, so it stays the same when
the program's kernels change. Rows are counted per distinct key, which is
at least the rows per distinct bucket a kernel touches.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, data sheet: HBM3 bytes per second
PEAK_BYTES_S = 3.35e12

# per query: the query, its directory entry, one key row (4 * B bytes),
# the found flag and the value word written out; a hit also reads its value
QUERY_BYTES = 4 + 4 + 1 + 4
# per write lane: kind, key, value, seq in; status out
LANE_BYTES = 4 + 4 + 4 + 4 + 1
INS, DEL = 1, 2
TRUE, FALSE = 1, 0


def lookup_bytes(n_queries: int, hits: int, bucket_size: int,
                 record_bytes: int = 0) -> float:
    """Bytes one lookup call needs: per query its own bytes and one key
    row, per hit its value word; with payloads, every query writes its
    record out and every hit reads it from the side store."""
    return (n_queries * (QUERY_BYTES + 4 * bucket_size) + hits * 4
            + n_queries * record_bytes + hits * record_bytes)


def apply_bytes(kinds: np.ndarray, keys: np.ndarray, status: np.ndarray,
                bucket_size: int, record_bytes: int = 0) -> float:
    """Bytes one write call needs: its lanes; one key row read per
    distinct key reached; a key row and a value row written per distinct
    key a TRUE op changed, a value row per distinct key whose only change
    is an applied update; and with payloads, one record written per
    distinct key an insert or update applied to."""
    row = 4 * bucket_size
    live = kinds != 0
    reached = np.unique(keys[live]).size
    hit = live & (status == TRUE)
    upd = live & (kinds == INS) & (status == FALSE)
    changed = np.unique(keys[hit]).size
    only_val = np.setdiff1d(np.unique(keys[upd]), keys[hit]).size
    written = np.unique(keys[(kinds == INS) & (hit | upd)]).size
    return (kinds.size * LANE_BYTES + reached * row + changed * 2 * row
            + only_val * row + written * record_bytes)
