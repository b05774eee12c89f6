"""``revlift_launches``: launches of the reversible lifting kernel per
request: the ``kernel="rev_lift"`` series of the program's
``repro_kernel_launches_total`` over its forward executions, one per
request, across the run (program counter).  One launch a level and
direction reads ``2 x levels``.  None where the program has no such
series."""
import sys

KERNEL = "rev_lift"


def read(reading):
    telemetry = sys.modules.get("repro_torch.telemetry")
    if telemetry is None:
        return None
    launches = telemetry.REGISTRY.get("repro_kernel_launches_total")
    execs = telemetry.REGISTRY.get("repro_plan_executions_total")
    if launches is None or execs is None:
        return None
    rows = [r["value"] for r in launches.series()
            if r["labels"].get("kernel") == KERNEL]
    n = sum(r["value"] for r in execs.series()
            if r["labels"].get("op") == "forward")
    if not rows or n <= 0:
        return None
    return sum(rows) / n
