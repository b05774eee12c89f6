"""``setup_s``: seconds from the process's start to the first timed
request: imports, CUDA initialisation, the kernels' build or load, the
data, the warm-up (host clock)."""


def read(reading):
    return reading.setup_s
