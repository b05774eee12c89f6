"""``first_launch_us``: the mean, over the ``call.*`` spans of the
traced sub-window, of the time from the call's start to its first
launch on the card: with nothing else queued, the time the card waits
for the host at the start of each call (program spans, on the
profiler's clock)."""
from portbench import program


def read(reading):
    p = program.of(reading)
    if p is None or not p.first_launch_s:
        return None
    return sum(p.first_launch_s) / len(p.first_launch_s) * 1e6
