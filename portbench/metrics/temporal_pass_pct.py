"""``temporal_pass_pct``: the share of the round trips' device time
(operations launched inside complete ``portbench.forward`` and
``portbench.inverse`` spans) launched inside the program's
``temporal.forward`` and ``temporal.inverse`` spans: the 3-D
transform's temporal pass whole, its lifting steps, scaling and the
interleave of its half-bands (program spans, on the profiler's
clock)."""
from portbench import program


def read(reading):
    p = program.of(reading)
    return None if p is None else p.device_pct("temporal.")
