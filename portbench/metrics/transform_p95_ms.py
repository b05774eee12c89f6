"""``transform_p95_ms``: the 95th percentile (linear between ranks) of
the latency of every request of the window, from its enqueue on the
host to its completion on the card as the host sees it (host clock)."""
import numpy as np


def read(reading):
    lat = reading.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
