"""The card's published peak and the least bytes of a transform.

NVIDIA H100 SXM5 80 GB: 3.35 TB/s of HBM3 bandwidth (NVIDIA's H100
data sheet, at the full 700 W power limit).  A card set below 700 W
runs slower under load, so every run prints the card's power limit.
"""
from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12}


def transform_bytes(samples: int, itemsize: int) -> int:
    """The least bytes one transform call moves: each input sample read
    once and each output sample written once.  A 2-D or 3-D pyramid has
    as many samples as its image, so the forward and the inverse move
    the same bytes, whatever implements them."""
    return 2 * samples * itemsize


def bytes_bound_s(nbytes: float, peaks: dict = H100_SXM) -> float:
    """The least time the card needs to move ``nbytes``."""
    return nbytes / peaks["hbm_bytes_per_s"]


def span_roofline_pct(reading, span: str):
    """The bytes roofline share of the calls traced under ``span``: the
    least time of their bytes over their operations' device time, in
    percent; None where the trace holds no complete call."""
    s = reading.summary
    if s is None:
        return None
    calls, seconds = s.span_seconds(span)
    if calls == 0 or seconds <= 0:
        return None
    least = bytes_bound_s(
        calls * transform_bytes(reading.request_samples, reading.itemsize))
    return 100.0 * least / seconds
