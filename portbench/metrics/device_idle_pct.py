"""``device_idle_pct``: the share of the traced device window (first
device operation to the last) in which no operation runs on the card:
one minus the union of the operations' intervals over the window
(device trace)."""


def read(reading):
    s = reading.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
