"""Readings for the check's limits, in one process on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \\
        --control-seeds 3 --seconds 3 [--first-seed N] [--out FILE]

Runs the workload through the harness (set-up, a short window at the
cell's own load and sizes, the check) on ``--seeds`` seeds with the
program as the configuration states it, then on ``--control-seeds``
seeds with the control in the program's place: the reference computed
in bfloat16.  Prints one line per run and, last, the lower reading of
each number (the largest over the sound runs) and the upper reading
(the smallest over the control's runs).  The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--first-seed", type=int, default=2 ** 31 + 7001)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness

    runs = [(False, args.first_seed + k) for k in range(args.seeds)]
    runs += [(True, args.first_seed + 1000 + k)
             for k in range(args.control_seeds)]
    lines = []
    for control, seed in runs:
        buf = io.StringIO()
        rc = harness.run(args.workload, seed, args.seconds, False,
                         control=control, out=buf, t_age=0.0)
        result = json.loads(buf.getvalue().strip().splitlines()[-1]) \
            if rc == 0 else {}
        line = {"control": control, "seed": seed, "rc": rc,
                "correct": result.get("correct"),
                "attempted": result.get("attempted"),
                "checks": {k: v["value"]
                           for k, v in result.get("checks", {}).items()}}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"workload": args.workload}
    for key, control, pick in (("lower", False, max), ("upper", True, min)):
        got = [ln for ln in lines if ln["control"] is control
               and ln["rc"] == 0]
        summary[key] = {k: pick(ln["checks"][k] for ln in got)
                        for k in (got[0]["checks"] if got else {})}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
