"""``revlift_pct``: the share of the round trips' device time
(operations launched inside complete ``portbench.forward`` and
``portbench.inverse`` spans) launched inside the program's
``revlift.forward`` and ``revlift.inverse`` spans: the levels of a
reversible wavelet; the rest is the glue around them, allocations and
copies (program spans, on the profiler's clock)."""
from portbench import program


def read(reading):
    p = program.of(reading)
    return None if p is None else p.device_pct("revlift.")
