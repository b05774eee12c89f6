"""``dispatch_self_us``: what the program spends above its executors,
per call: the host self time of its ``call.*`` spans (the entry point's
own work), ``plan.lookup`` (the plan cache) and ``execute.*`` (the
resilient dispatch around the executor), each less the spans nested
inside it, summed over the traced sub-window and divided by the number
of ``call.*`` spans there (program spans, on the profiler's clock)."""
from portbench import program


def read(reading):
    p = program.of(reading)
    if p is None or p.calls == 0:
        return None
    own = p.matching(program.CALLS, "plan.lookup", "execute.").self_s
    return own / p.calls * 1e6
