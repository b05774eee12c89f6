"""``dwt_fwd_roofline``: the forward transform's share of its bytes
roofline: the least time the card needs for the call's own bytes (each
input sample read once, each pyramid sample written once; see
``portbench.peaks``), over the summed device time of every operation
launched inside the call's ``portbench.forward`` span (device trace)."""
from portbench import peaks


def read(reading):
    return peaks.span_roofline_pct(reading, "portbench.forward")
