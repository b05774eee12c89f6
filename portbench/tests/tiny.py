"""Runs of a workload at its configuration's tiny size for the CPU
tests: the ``tiny`` key of each configuration file cuts every axis,
each still divisible by ``2**levels`` and by the traffic's split."""
import io
import json

SEED = 2 ** 31 + 12345


def run_tiny(workload, seed=SEED, seconds=0.5, trace=False, **kw):
    """One CPU run of ``workload`` at its tiny size: (exit code, the
    result line as a dict or None, standard error)."""
    from portbench import harness
    tiny = harness.cell(workload)["config_data"]["tiny"]
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, seed, seconds, trace, device_type="cpu",
                     config_overrides=tiny, out=out, err=err, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
