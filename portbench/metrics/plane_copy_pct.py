"""``plane_copy_pct``: the share of the round trips' device time
(operations launched inside complete ``portbench.forward`` and
``portbench.inverse`` spans) launched inside the program's
``planes.split`` and ``planes.merge`` spans: the copies that make a
level's polyphase planes contiguous for K1 and interleave them back
into an image (program spans, on the profiler's clock)."""
from portbench import program


def read(reading):
    p = program.of(reading)
    return None if p is None else p.device_pct("planes.")
