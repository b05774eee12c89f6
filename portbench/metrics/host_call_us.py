"""``host_call_us``: the mean host time of one call into the program
(``dwt2``/``idwt2`` or ``dwt3``/``idwt3``), measured around the call
with no synchronise inside, over every call of the window made while
the profiler was off (host clock)."""


def read(reading):
    calls = reading.window.calls_s
    if not calls:
        return None
    return sum(calls) / len(calls) * 1e6
