"""The traced run: a ``torch.profiler`` window and its reduction.

A run with ``--trace 1`` profiles a sub-window of its measured window
(the traffic's ``trace_seconds``, centred), with the harness's own
spans around each call into the program (``portbench.forward``,
``portbench.inverse``, ``portbench.wait``).  The profile is exported as
a Chrome trace into the run's temporary directory, read back and
reduced here to what the per-layer readers use:

* the device operations (kernels, copies, fills) on the card's timeline,
  and the traced device window, from the first of them to the last;
* the busy time, the union of their intervals, and the idle gaps
  between them, each named by the innermost host event under way at the
  gap's middle;
* for each span name, the device time of the operations launched
  inside each instance of it, by operation name, counting only
  instances whose every launch reached the trace.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: the harness's spans whose launches are attributed to them
SPANS = ("portbench.forward", "portbench.inverse")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: host calls that put an operation on the card (launches, copies, fills)
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class Tracer:
    """Starts the profiler when the window reaches the traced sub-window
    and stops it when the sub-window ends; inert when tracing is off."""

    def __init__(self, enabled: bool, seconds: float, trace_seconds: float,
                 device_type: str):
        self.enabled = enabled
        span = min(float(trace_seconds), float(seconds))
        self.start_at = (float(seconds) - span) / 2
        self.stop_at = self.start_at + span
        self.device_type = device_type
        self.prof = None
        self.active = False
        self.done = False

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Initialise the profiler once in set-up, so its first start
        does not stall the window."""
        if self.enabled:
            with self._profile():
                pass

    def tick(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if not self.active and elapsed >= self.start_at:
            self.prof = self._profile()
            self.prof.start()
            self.active = True
        elif self.active and elapsed >= self.stop_at:
            self.stop()

    def stop(self) -> None:
        if self.active:
            self.prof.stop()
            self.active, self.done = False, True

    def export(self, path: Path) -> Optional[dict]:
        """The Chrome trace of the sub-window, or None when nothing was
        traced."""
        self.stop()
        if self.prof is None:
            return None
        self.prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                return json.load(f)
        finally:
            path.unlink(missing_ok=True)


@dataclasses.dataclass
class Summary:
    """What the per-layer readers read from one traced sub-window."""

    window_s: float                       # first device op to the last
    busy_s: float                         # union of device op intervals
    device_ops: Dict[str, float]          # seconds by operation name
    idle_gaps: List[Tuple[str, float]]    # the longest, named, seconds
    #: per span name: (complete instances, {operation: seconds})
    spans: Dict[str, Tuple[int, Dict[str, float]]]

    def span_seconds(self, span: str) -> Tuple[int, float]:
        n, ops = self.spans.get(span, (0, {}))
        return n, sum(ops.values())


def _events(doc: dict) -> List[dict]:
    return [e for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals: Sequence[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(host: List[dict], t: float) -> str:
    inside = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
    return min(inside, key=lambda e: e["dur"])["name"] if inside \
        else "(no host event)"


def reduce(doc: Optional[dict], spans: Sequence[str] = SPANS
           ) -> Optional[Summary]:
    """Reduce a Chrome trace; None when it holds no device operation."""
    if doc is None:
        return None
    evs = _events(doc)
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy = sum(b - a for a, b in merged)
    ops: Dict[str, float] = collections.defaultdict(float)
    for e in dev:
        ops[e["name"]] += e["dur"] * 1e-6

    host = [e for e in evs if e.get("cat") in HOST_CATS]
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = [(_innermost(host, (a + b) / 2), (b - a) * 1e-6)
             for a, b in gaps[:TOP]]

    by_corr = {e["args"]["correlation"]: e for e in dev
               if "correlation" in e.get("args", {})}
    launches = sorted(
        (e["ts"], e["args"]["correlation"]) for e in evs
        if e.get("cat") in LAUNCH_CATS
        and any(w in e["name"] for w in LAUNCH_WORDS)
        and "correlation" in e.get("args", {}))
    starts = [ts for ts, _ in launches]
    per_span: Dict[str, Tuple[int, Dict[str, float]]] = {}
    for name in spans:
        n, acc = 0, collections.defaultdict(float)
        for s in (e for e in host if e.get("cat") == "user_annotation"
                  and e["name"] == name):
            lo = bisect.bisect_left(starts, s["ts"])
            hi = bisect.bisect_right(starts, s["ts"] + s["dur"])
            corrs = [c for _, c in launches[lo:hi]]
            if not corrs or not all(c in by_corr for c in corrs):
                continue                  # a launch that left the trace
            n += 1
            for c in corrs:
                k = by_corr[c]
                acc[k["name"]] += k["dur"] * 1e-6
        per_span[name] = (n, dict(acc))
    return Summary(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6,
                   device_ops=dict(ops), idle_gaps=named, spans=per_span)


def breakdown(summary: Optional[Summary]) -> Optional[dict]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, ten of each."""
    if summary is None:
        return None
    top = sorted(summary.device_ops.items(), key=lambda kv: kv[1],
                 reverse=True)[:TOP]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
