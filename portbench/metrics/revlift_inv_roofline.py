"""``revlift_inv_roofline``: as ``revlift_fwd_roofline``, for the
inverse: each subband sample read once and each reconstructed sample
written once per complete ``portbench.inverse`` call, over the device
time launched inside the program's ``revlift.inverse`` spans (program
spans)."""
from portbench import revlift


def read(reading):
    return revlift.roofline_pct(reading, "portbench.inverse",
                                "revlift.inverse")
