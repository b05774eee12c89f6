"""The comparison that decides ``correct``.

For each request the window kept, the plain reference of the
configuration's wavelet (:func:`portbench.reference.load`) transforms
the request's input again, in float64 and in blocks, and the program's
outputs are judged against it (each driver's ``compare``; a round trip,
:mod:`portbench.drivers.roundtrip`, gives these two numbers):

``fwd_err``
    every subband of the forward pyramid (the output of K2, or of K1 and
    the temporal pass): the largest ``|program - reference|`` over the
    subband, over the larger of the subband's largest ``|reference|``
    and the median of those over all subbands (so a subband that is
    nearly zero is not judged on its own tiny scale).  The worst
    subband of the worst request.
``inv_err``
    the inverse's reconstruction (the output of K3, or of K1 and the
    temporal pass, run on the program's own pyramid): the largest
    ``|program - reference|`` over the largest ``|reference|``, where
    the reference inverts its own pyramid.  The worst request.

Each number has its limit in ``portbench/limits/<workload>.json``, set
from readings of sound runs and of the lower-precision control, as
``PERF.md`` records.  A number at or under its limit passes.
This module holds what every driver's comparison shares.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List

import torch

LIMITS = Path(__file__).resolve().parent / "limits"

#: samples of one reference block (float64, with its temporaries)
BLOCK_SAMPLES = 1 << 25


def limits(workload: str) -> Dict[str, float]:
    """The workload's limits, by number name."""
    with open(LIMITS / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def blocks(n: int, per: int) -> List[slice]:
    """Slices of ``n`` rows of ``per`` samples each, a block at a time."""
    step = max(1, BLOCK_SAMPLES // max(per, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


class Worst:
    """Running largest ``|diff|`` and largest ``|reference|`` of each
    output, accumulated block by block."""

    def __init__(self, n: int):
        self.diff = [0.0] * n
        self.ref = [0.0] * n

    def add(self, i: int, got: torch.Tensor, want: torch.Tensor) -> None:
        d = float((got.to(torch.float64) - want).abs().max())
        self.diff[i] = math.inf if math.isnan(d) else max(self.diff[i], d)
        self.ref[i] = max(self.ref[i], float(want.abs().max()))

    def scaled(self) -> float:
        floor = statistics.median(self.ref)
        return max(d / max(r, floor) if max(r, floor) > 0 else math.inf
                   for d, r in zip(self.diff, self.ref))


def judge(numbers: Dict[str, float], limit: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite
    fails)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limit[k]
               for k in limit)
