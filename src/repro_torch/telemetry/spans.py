"""Structured span tracer: nested timed spans over the whole pipeline.

``span("plan.build", scheme="cdf97")`` is a context manager producing
one timed :class:`SpanRecord` — start/duration, a span id, a parent id
(spans nest through a :mod:`contextvars` variable, so nesting is correct
across threads *and* asyncio tasks), the label set, and the recording
thread.  Records land in a bounded in-memory ring (:class:`SpanTracer`;
``$REPRO_TORCH_TELEMETRY_RING`` entries, default 4096 — a long-lived
process never grows without limit, evictions are counted) and export as
Chrome-trace-event JSON loadable in Perfetto
(:func:`repro_torch.telemetry.export.chrome_trace`).

**Device time.**  A kernel launch returns long before the card has run
it, so a host clock around device work times the launch, not the work.
The spans that wrap device work (``execute.*``, ``level.*``,
``pyramid.launch``, ``packet.*``, ``level3.*``, ``revlift.*``) open through
:func:`device_span` with the plan's device: on a CUDA device the span
records a CUDA event pair on the device's current stream, one at entry
and one at exit, and its ``duration`` is the time the card took between
them.  Nothing waits for the card when the span closes: the pair is
resolved lazily, when ``duration`` or the record's ``dur_s`` is first
read (which waits for the exit event only).  The engine hands its
``execute.*`` records to the live roofline unresolved
(:func:`repro_torch.telemetry.attribution.record_span`), which resolves
them when the roofline or an export is read; the ring's records are
resolved when the ring is read.  On the CPU the same spans time the
host.

**On the profiler's clock.**  While a ``torch.profiler`` session
records, every span in every mode but ``off`` is also a range of its
name in the profiler's trace, around the kernels it launches and on one
clock with them: a gap on the card's timeline is named by the innermost
span under way on the host.  In ``spans`` mode the range is a
``torch.profiler.record_function`` (a user annotation, projected onto
the card's timeline too).  In ``counters`` mode the range is all a span
does, and it is the profiler's own C++ record function (a host operation
of the span's name in the trace): ``record_function`` is a pair of
dispatched operators, which the profiler records as operations of their
own, and costs about eight times as much there.

Overhead discipline:

* spans only record under ``REPRO_TORCH_TELEMETRY=spans``; otherwise,
  with no profiler session recording, :func:`span` / :func:`device_span`
  return one shared no-op context manager — the cost of an instrument
  site is a branch, one flag read and a constant return; no event is
  recorded and nothing waits for the device;
* a span opened while ``torch.compile`` traces is also a no-op: a
  trace-time measurement would time compilation once and then never
  fire again.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.telemetry.config import CONFIG

RING_ENV = "REPRO_TORCH_TELEMETRY_RING"
DEFAULT_RING = 4096


class _CudaTiming:
    """A CUDA event pair on one stream: the device time of a span."""

    __slots__ = ("start", "end")

    def __init__(self, stream):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(stream)

    def stop(self, stream) -> None:
        self.end.record(stream)

    def seconds(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


class SpanRecord:
    """One completed span (what the ring stores and exports).

    ``dur_s`` is seconds: host time, or for a span timed on the card
    (``clock == "cuda"``) the device time between its two events,
    resolved on first read."""

    __slots__ = ("name", "start_s", "_dur", "span_id", "parent_id",
                 "labels", "thread", "clock")

    def __init__(self, name: str, start_s: float, dur_s, span_id: int,
                 parent_id: Optional[int], labels: dict, thread: str,
                 clock: str = "host"):
        self.name = name
        self.start_s = start_s      # perf_counter timestamp at __enter__
        self._dur = dur_s           # seconds, or a pending _CudaTiming
        self.span_id = span_id
        self.parent_id = parent_id
        self.labels = labels
        self.thread = thread        # recording thread name (trace "tid")
        self.clock = clock          # "host" | "cuda"

    @property
    def dur_s(self) -> float:
        if isinstance(self._dur, _CudaTiming):
            self._dur = self._dur.seconds()
        return self._dur

    def __repr__(self) -> str:
        return (f"SpanRecord(name={self.name!r}, span_id={self.span_id}, "
                f"parent_id={self.parent_id}, clock={self.clock!r}, "
                f"labels={self.labels!r})")


class SpanTracer:
    """Bounded ring of completed spans + the id allocator."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(RING_ENV, DEFAULT_RING))
            except ValueError:
                capacity = DEFAULT_RING
        self.capacity = max(1, capacity)
        self._ring: "deque[SpanRecord]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.dropped = 0
        self.recorded = 0

    def next_id(self) -> int:
        return next(self._ids)

    def add(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)
            self.recorded += 1

    def records(self) -> List[SpanRecord]:
        """Oldest-first copy of the ring."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.recorded = 0

    def stats(self) -> dict:
        with self._lock:
            return {"recorded": self.recorded, "resident": len(self._ring),
                    "dropped": self.dropped, "capacity": self.capacity}


#: process-global tracer (one trace per process; tests clear() between
#: cases via repro_torch.telemetry.reset())
TRACER = SpanTracer()

# the active span of the current thread/task: contextvars give each
# thread AND each asyncio task its own value
_CURRENT: "contextvars.ContextVar[Optional[_ActiveSpan]]" = \
    contextvars.ContextVar("repro_torch_telemetry_span", default=None)


def _compiling() -> bool:
    """True while ``torch.compile`` traces: spans there would time
    compilation, not execution."""
    try:
        return torch.compiler.is_compiling()
    except AttributeError:
        return False


class _NoopSpan:
    """Shared do-nothing span (mode off, counters with no profiler
    session recording, or under tracing)."""

    __slots__ = ()
    duration: Optional[float] = None
    record: Optional["SpanRecord"] = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


#: the profiler's own record function, where this torch has it
_FAST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class _RangeSpan:
    """A span outside ``spans`` mode while a profiler session records:
    a range of its name in the trace and nothing else (no CUDA event, no
    ring record)."""

    __slots__ = ("_range",)
    duration: Optional[float] = None
    record: Optional["SpanRecord"] = None

    def __init__(self, name: str):
        self._range = _FAST_RANGE(name) if _FAST_RANGE is not None \
            else torch.profiler.record_function(name)

    def __enter__(self) -> "_RangeSpan":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return False


class _ActiveSpan:
    """A live span: times itself (on the host, or on the card between two
    CUDA events of ``stream``), parents through the context var, and
    appends its :class:`SpanRecord` to the tracer on exit.  Exposes the
    ``record`` (None until exit) so callers can feed attribution without
    re-timing, and its ``duration`` in seconds (reading it waits for the
    card when the span was timed there)."""

    __slots__ = ("name", "labels", "span_id", "parent_id", "start_s",
                 "_token", "_prof_ctx", "_tracer", "_stream", "_timing",
                 "record")

    def __init__(self, name: str, labels: dict, stream=None,
                 tracer: SpanTracer = TRACER):
        self.name = name
        self.labels = labels
        self._tracer = tracer
        self._stream = stream
        self.span_id = tracer.next_id()
        self.parent_id: Optional[int] = None
        self.start_s = 0.0
        self._token = None
        self._prof_ctx = None
        self._timing = None
        self.record: Optional[SpanRecord] = None

    @property
    def duration(self) -> Optional[float]:
        return self.record.dur_s if self.record is not None else None

    def __enter__(self) -> "_ActiveSpan":
        parent = _CURRENT.get()
        self.parent_id = parent.span_id if parent is not None else None
        self._token = _CURRENT.set(self)
        if _profiler._is_profiler_enabled:
            self._prof_ctx = torch.profiler.record_function(self.name)
            self._prof_ctx.__enter__()
        self.start_s = time.perf_counter()
        if self._stream is not None:
            self._timing = _CudaTiming(self._stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self._timing is not None:
            self._timing.stop(self._stream)
            dur, clock = self._timing, "cuda"
        else:
            dur, clock = time.perf_counter() - self.start_s, "host"
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        _CURRENT.reset(self._token)
        self.record = SpanRecord(
            name=self.name, start_s=self.start_s, dur_s=dur,
            span_id=self.span_id, parent_id=self.parent_id,
            labels=self.labels, thread=threading.current_thread().name,
            clock=clock)
        self._tracer.add(self.record)
        return False


def span(name: str, **labels):
    """Open one host-timed span (a context manager).

    Records under ``REPRO_TORCH_TELEMETRY=spans``; in ``counters`` mode
    it is only a profiler range while a profiler session records, and a
    no-op otherwise, as it is under ``off`` and while ``torch.compile``
    traces.  Labels become the span's Perfetto ``args`` and the grouping
    keys of :func:`span_summary`.

        with span("plan.build", backend="cuda", scheme="ns-polyconv"):
            plan = build_plan(key)
    """
    if CONFIG.spans_on:
        return NOOP_SPAN if _compiling() else _ActiveSpan(name, labels)
    if _profiler._is_profiler_enabled and CONFIG.counters_on \
            and not _compiling():
        return _RangeSpan(name)
    return NOOP_SPAN


def device_span(name: str, device, **labels):
    """Open one span around work that runs on ``device`` (a plan's
    device string or a ``torch.device``): timed on the card between two
    CUDA events of the device's current stream when ``device`` is a CUDA
    device, on the host otherwise.  Outside ``spans`` mode it is what
    :func:`span` is there.

        with device_span("execute.forward", plan.key.device, fuse="levels"):
            out = plan.run("forward", x)
    """
    if not CONFIG.spans_on:
        if _profiler._is_profiler_enabled and CONFIG.counters_on \
                and not _compiling():
            return _RangeSpan(name)
        return NOOP_SPAN
    if _compiling():
        return NOOP_SPAN
    dev = torch.device(device)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    return _ActiveSpan(name, labels, stream=stream)


def current_span() -> Optional[_ActiveSpan]:
    """The innermost open span of this thread/task, or None."""
    return _CURRENT.get()


def span_summary(tracer: Optional[SpanTracer] = None,
                 top: Optional[int] = None) -> List[dict]:
    """Aggregate the ring by span name: count, total/mean/max seconds
    (device seconds for spans timed on the card), sorted by total time
    descending."""
    recs = (tracer or TRACER).records()
    agg: dict = {}
    for r in recs:
        row = agg.setdefault(r.name, {"name": r.name, "count": 0,
                                      "total_s": 0.0, "max_s": 0.0,
                                      "clock": r.clock})
        row["count"] += 1
        row["total_s"] += r.dur_s
        row["max_s"] = max(row["max_s"], r.dur_s)
    rows = sorted(agg.values(), key=lambda r: -r["total_s"])
    for r in rows:
        r["mean_s"] = r["total_s"] / r["count"]
    return rows[:top] if top is not None else rows


def synchronising_calls(fn) -> List[tuple]:
    """Run ``fn()`` under PyTorch's CUDA sync debug mode and return the
    synchronising calls it made, as ``[(file:line, message), ...]`` — how
    the port checks that an instrument adds no wait for the card."""
    import warnings
    from pathlib import Path
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    # the mode's one-time notice ("Synchronization debug mode is a
    # prototype feature ...") is not a synchronising call
    return [(f"{Path(w.filename).name}:{w.lineno}", str(w.message)[:120])
            for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
