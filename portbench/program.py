"""The program's own spans and counters in a run, for the per-layer
readers that read the program from inside.

While a profiler session records, the program opens a range for each
of its spans (``call.*``, ``plan.lookup``, ``execute.*``, ``level3.*``,
``temporal.*``, ``planes.*``, ...), so a traced run's profile holds them
beside the harness's ``portbench.*`` ranges, on one clock with the
kernels they launch: host operations named like the span in the
program's default mode, user annotations (``record_function``) in its
``spans`` mode.  :func:`reduce` reads them from the same Chrome-trace
form :mod:`portbench.trace` reads:

* for each range name outside ``portbench.*``: its instances, their host
  seconds, their host self seconds (each instance's interval less the
  intervals of the ranges nested inside it on its thread), and the
  device seconds of the operations launched inside them;
* for each ``call.*`` instance (the root of one call into the program),
  the time from its start to its first launch: the time the card waits
  for the host when nothing else is queued.

Device seconds count only operations of round trips whose every launch
reached the trace (complete ``portbench.forward`` / ``portbench.inverse``
instances, as :mod:`portbench.trace` counts them), so a span's device
seconds over :attr:`Program.round_trip_s` is a share of the round
trips' device time.

The harness hands its readers the reduced :class:`portbench.trace.
Summary` only, and a profile saves its Chrome trace once.  So
:func:`of` finds the run's :class:`portbench.trace.Tracer` on the
calling stack and rebuilds the trace's events from its profile
(:func:`events`).  :func:`per_request` reads the program's counters
from its registry.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import sys
from typing import Dict, List, Optional

from portbench import trace as TR

HARNESS = "portbench."
CALLS = "call."
#: the form of a span's name: dotted words
SPAN_NAME = re.compile(r"[A-Za-z_]\w*(\.\w+)+")
#: a range within this many microseconds of its parent's edge still
#: nests (the trace's timestamps are rounded to nanoseconds)
EDGE_US = 1e-3


@dataclasses.dataclass
class Span:
    """One span name's instances in the traced sub-window."""

    instances: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0


@dataclasses.dataclass
class Program:
    """What the program's spans read in one traced sub-window."""

    spans: Dict[str, Span]
    #: per ``call.*`` instance that launched: seconds to its first launch
    first_launch_s: List[float]
    #: device seconds of the complete ``portbench.*`` round trips
    round_trip_s: float

    def matching(self, *prefixes: str) -> Span:
        """The sum over the span names that start with any of
        ``prefixes`` (a whole name matches itself)."""
        out = Span()
        for name, s in self.spans.items():
            if name.startswith(prefixes):
                out.instances += s.instances
                out.host_s += s.host_s
                out.self_s += s.self_s
                out.device_s += s.device_s
        return out

    @property
    def calls(self) -> int:
        return self.matching(CALLS).instances

    def device_pct(self, *prefixes: str) -> Optional[float]:
        """The device seconds launched inside the spans of ``prefixes``
        as a share of the round trips' device seconds; None where either
        is nothing."""
        part = self.matching(*prefixes).device_s
        if part <= 0 or self.round_trip_s <= 0:
            return None
        return 100.0 * part / self.round_trip_s


def reduce(doc: Optional[dict]) -> Optional[Program]:
    """Reduce a Chrome trace to the program's spans; None when it holds
    no range of the program."""
    if doc is None:
        return None
    evs = TR._events(doc)
    ranges = [e for e in evs if _is_range(e)]
    if not any(not e["name"].startswith(HARNESS) for e in ranges):
        return None
    by_corr = {e["args"]["correlation"]: e for e in evs
               if e.get("cat") in TR.DEVICE_CATS
               and "correlation" in e.get("args", {})}
    launches = sorted(
        (e["ts"], e["args"]["correlation"]) for e in evs
        if e.get("cat") in TR.LAUNCH_CATS
        and any(w in e["name"] for w in TR.LAUNCH_WORDS)
        and "correlation" in e.get("args", {}))
    starts = [ts for ts, _ in launches]

    def launched(e) -> List:
        lo = bisect.bisect_left(starts, e["ts"])
        hi = bisect.bisect_right(starts, e["ts"] + e["dur"])
        return launches[lo:hi]

    # the round trips whose every launch reached the trace
    counted, round_trip = set(), 0.0
    for e in ranges:
        if e["name"] not in TR.SPANS:
            continue
        corrs = [c for _, c in launched(e)]
        if corrs and all(c in by_corr for c in corrs):
            counted.update(corrs)
            round_trip += sum(by_corr[c]["dur"] for c in corrs)

    nested = _nested_us(ranges)
    spans: Dict[str, Span] = collections.defaultdict(Span)
    first: List[float] = []
    for i, e in enumerate(ranges):
        if e["name"].startswith(HARNESS):
            continue
        inside = launched(e)
        s = spans[e["name"]]
        s.instances += 1
        s.host_s += e["dur"] * 1e-6
        s.self_s += (e["dur"] - nested[i]) * 1e-6
        s.device_s += sum(by_corr[c]["dur"] for _, c in inside
                          if c in counted) * 1e-6
        if e["name"].startswith(CALLS) and inside:
            first.append((inside[0][0] - e["ts"]) * 1e-6)
    return Program(spans=dict(spans), first_launch_s=first,
                   round_trip_s=round_trip * 1e-6)


def _is_range(e: dict) -> bool:
    """A span's range: a user annotation, or a host operation with a
    span's dotted name (``call.dwt2``; not an operator's ``aten::add``,
    a runtime call's ``cudaFuncSetAttribute`` or the profiler's own
    ``Activity Buffer Request``)."""
    cat = e.get("cat")
    return cat == "user_annotation" or (
        cat == "cpu_op" and SPAN_NAME.fullmatch(e["name"]) is not None)


def _nested_us(ranges: List[dict]) -> List[float]:
    """For each range, the microseconds its direct children (the ranges
    nested inside it on its thread) cover."""
    covered = [0.0] * len(ranges)
    order = sorted(range(len(ranges)), key=lambda i: (
        str(ranges[i].get("tid")), ranges[i]["ts"], -ranges[i]["dur"]))
    stack: List[int] = []
    tid = object()
    for i in order:
        e = ranges[i]
        if e.get("tid") != tid:
            stack, tid = [], e.get("tid")
        while stack and _end(ranges[stack[-1]]) < e["ts"] + EDGE_US:
            stack.pop()
        if stack and _end(e) <= _end(ranges[stack[-1]]) + EDGE_US:
            covered[stack[-1]] += e["dur"]
        stack.append(i)
    return covered


def _end(e: dict) -> float:
    return e["ts"] + e["dur"]


# ---------------------------------------------------------------------------
# The run's profile and the program's registry
# ---------------------------------------------------------------------------

def events(prof) -> dict:
    """A stopped profile's events in the Chrome-trace form :func:`reduce`
    reads: user ranges, host operations, launches and device operations,
    each with its start and duration in microseconds from the first
    event and its thread, and launches and device operations with their
    correlation.  Read from the profiler's own record of its events,
    which outlives the export of its trace, without building its
    function events (a second per hundred thousand events, against tens
    of seconds)."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        name = e.name()
        event = {"ph": "X", "name": name, "ts": (e.start_ns() - base) / 1e3,
                 "dur": e.duration_ns() / 1e3, "tid": e.start_thread_id()}
        ranged = e.is_user_annotation()
        if e.device_type() != DeviceType.CPU:
            if ranged:
                continue                   # the ranges' copy on the card
            event["cat"] = TR.DEVICE_CATS[0]
            event["args"] = {"correlation": e.correlation_id()}
        elif ranged:
            event["cat"] = "user_annotation"
        elif "::" not in name and any(w in name for w in TR.LAUNCH_WORDS):
            event["cat"] = TR.LAUNCH_CATS[0]
            event["args"] = {"correlation": e.correlation_id()}
        else:
            event["cat"] = "cpu_op"
        out.append(event)
    return {"traceEvents": out}


def _tracer() -> Optional[TR.Tracer]:
    """The run's tracer, a local of a caller's frame."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, TR.Tracer):
                return value
        frame = frame.f_back
    return None


def of(reading) -> Optional[Program]:
    """The program's spans in the run the readers read (computed once
    per reading), or None where nothing was traced or the program opened
    no range."""
    if not hasattr(reading, "_program"):
        tracer = _tracer()
        prof = tracer.prof if tracer is not None else None
        reading._program = reduce(events(prof)) if prof is not None \
            else None
    return reading._program


def per_request(metric: str) -> Optional[float]:
    """The program's counter ``metric``, summed over its series, per
    forward execution (one per request), over the whole run: set-up
    runs the same requests as the window.  None where the program has
    no such counter or ran nothing."""
    telemetry = sys.modules.get("repro_torch.telemetry")
    if telemetry is None:
        return None
    counter = telemetry.REGISTRY.get(metric)
    execs = telemetry.REGISTRY.get("repro_plan_executions_total")
    if counter is None or execs is None:
        return None
    n = sum(r["value"] for r in execs.series()
            if r["labels"].get("op") == "forward")
    if n <= 0:
        return None
    return sum(r["value"] for r in counter.series()) / n
