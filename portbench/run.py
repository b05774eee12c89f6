"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One process on one card: set-up (kernels from the checkout's build
cache, data made on the card from the seed, the workload's shape warmed
up), a measured window of ``--seconds``, the check of what the window
produced against the plain reference, and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the workload's end-to-end metrics, or with
``--trace 1`` its per-layer metrics and a ``breakdown``), ``device``
and ``checks``.  Without a CUDA card it exits with code 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
