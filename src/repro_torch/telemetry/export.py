"""Exporters: Prometheus text exposition + Chrome-trace (Perfetto) JSON.

Stdlib only — no ``prometheus_client`` dependency.  Two standard
surfaces out of the one registry/tracer pair:

* :func:`prometheus_text` renders the registry in the Prometheus text
  exposition format (v0.0.4): ``# HELP`` / ``# TYPE`` headers, escaped
  label values, cumulative ``_bucket{le=...}`` + ``_sum``/``_count``
  rows for histograms.  Serve it from any HTTP handler and point a
  scraper at it.
  :func:`parse_prometheus_text` is the matching minimal parser (used by
  the round-trip tests and handy for ad-hoc scraping in CI).
* :func:`chrome_trace` renders the span ring as a Chrome trace-event
  document (``traceEvents`` with complete "X" events in microseconds)
  — load it at https://ui.perfetto.dev or ``chrome://tracing`` to see
  the nested plan/compile/execute timeline per thread.  A span timed on
  the card (:func:`repro_torch.telemetry.spans.device_span`) keeps its
  host start and gives its device duration, with ``args.clock`` =
  ``"cuda"``.  :func:`write_chrome_trace` writes it to disk.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.telemetry import attribution as A
from repro_torch.telemetry import registry as R
from repro_torch.telemetry import spans as SP


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:                       # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry: Optional[R.MetricsRegistry] = None) -> str:
    """Render every metric in the Prometheus text exposition format (the
    global registry's with the live roofline resolved first)."""
    if registry is None:
        A.resolve_pending()
        registry = R.REGISTRY
    lines = []
    for m in registry:
        lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for row in m.series():
            if m.kind == "histogram":
                for ub, cum in row["buckets"].items():
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(row['labels'], {'le': _fmt_value(ub)})}"
                        f" {cum}")
                lines.append(
                    f"{m.name}_bucket"
                    f"{_fmt_labels(row['labels'], {'le': '+Inf'})}"
                    f" {row['count']}")
                lines.append(f"{m.name}_sum{_fmt_labels(row['labels'])} "
                             f"{_fmt_value(row['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(row['labels'])} "
                             f"{row['count']}")
            else:
                lines.append(f"{m.name}{_fmt_labels(row['labels'])} "
                             f"{_fmt_value(row['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: ``{metric_name: [(labels,
    value), ...]}`` — enough for the round-trip tests and CI checks (not
    a spec-complete scraper)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelstr, valstr = rest.rsplit("}", 1)
            labels = {}
            for part in _split_labels(labelstr):
                k, v = part.split("=", 1)
                labels[k] = (v[1:-1].replace(r'\"', '"')
                             .replace(r"\n", "\n").replace(r"\\", "\\"))
        else:
            name, valstr = line.rsplit(None, 1) if " " in line \
                else (line, "0")
            labels = {}
        valstr = valstr.strip()
        value = (float("inf") if valstr == "+Inf"
                 else float("-inf") if valstr == "-Inf"
                 else float(valstr))
        out.setdefault(name.strip(), []).append((labels, value))
    return out


def _split_labels(s: str):
    """Split 'a="x",b="y,z"' on commas outside quoted values."""
    parts, cur, in_q, prev = [], [], False, ""
    for ch in s:
        if ch == '"' and prev != "\\":
            in_q = not in_q
        if ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        prev = ch
    if cur:
        parts.append("".join(cur))
    return [p for p in (x.strip() for x in parts) if p]


# ---------------------------------------------------------------------------
# Chrome trace events (Perfetto)
# ---------------------------------------------------------------------------

def chrome_trace(tracer: Optional[SP.SpanTracer] = None) -> dict:
    """The span ring as a Chrome trace-event document (JSON-serializable
    dict).  Spans become complete ("X") events in microseconds, one
    lane ("tid") per recording thread, so Perfetto shows the nested
    plan -> compile -> execute timeline exactly as measured."""
    tracer = tracer if tracer is not None else SP.TRACER
    recs = tracer.records()
    tids = {}
    events = []
    pid = os.getpid()
    for r in recs:
        tid = tids.setdefault(r.thread, len(tids) + 1)
        args = {str(k): v for k, v in r.labels.items()}
        args["span_id"] = r.span_id
        if r.parent_id is not None:
            args["parent_id"] = r.parent_id
        if r.clock != "host":
            args["clock"] = r.clock
        events.append({
            "name": r.name,
            "cat": r.name.split(".", 1)[0],
            "ph": "X",
            "ts": r.start_s * 1e6,
            "dur": r.dur_s * 1e6,
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    # thread-name metadata rows give Perfetto readable lane labels
    for thread, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": thread}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.telemetry",
                          "spans_dropped": tracer.stats()["dropped"]}}


def write_chrome_trace(path, tracer: Optional[SP.SpanTracer] = None) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns the path."""
    doc = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)
