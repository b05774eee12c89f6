"""``dwt_inv_roofline``: as ``dwt_fwd_roofline``, for the inverse: each
pyramid sample read once, each reconstructed sample written once, over
the device time launched inside ``portbench.inverse`` (device trace)."""
from portbench import peaks


def read(reading):
    return peaks.span_roofline_pct(reading, "portbench.inverse")
