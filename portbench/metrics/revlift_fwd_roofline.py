"""``revlift_fwd_roofline``: the reversible lifting kernel's share of its
bytes roofline in the forward transform: the least time the card needs
for each complete ``portbench.forward`` call's own bytes (each input
sample read once, each subband sample written once, in int32) over the
device time of the operations launched inside the program's
``revlift.forward`` spans (program spans, on the profiler's clock with
the device trace; see ``portbench/revlift.py``)."""
from portbench import revlift


def read(reading):
    return revlift.roofline_pct(reading, "portbench.forward",
                                "revlift.forward")
