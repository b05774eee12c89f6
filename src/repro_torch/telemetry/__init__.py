"""``repro_torch.telemetry`` — observability for the port.

The reference package's telemetry plane, in PyTorch (see
:mod:`repro_torch.telemetry.spans` for what changes on the card):

* **metrics registry** (:mod:`repro_torch.telemetry.registry`) — named
  counters / gauges / bucketed histograms with label sets, thread-safe,
  process-global (:data:`REGISTRY`), with nested-dict :func:`snapshot`,
  Prometheus text exposition
  (:func:`repro_torch.telemetry.export.prometheus_text`, stdlib only) and
  per-test :func:`reset`.  Metric names are the reference's
  (``repro_*``);
* **span tracer** (:mod:`repro_torch.telemetry.spans`) — ``with
  span("plan.build", scheme=...):`` nested timed spans with ids and
  parents in a bounded ring, exported as Perfetto-loadable Chrome-trace
  JSON (:func:`repro_torch.telemetry.export.chrome_trace`); spans around
  device work are timed on the card with CUDA events, and every span is
  a range of its name in a ``torch.profiler`` trace while a profiler
  session records;
* **attribution** (:mod:`repro_torch.telemetry.attribution`) — measured
  span time joined with the modelled device-memory bytes and compiled
  MACs into achieved-GB/s / achieved-MACs/s gauges (a live roofline).

Everything is gated on ``$REPRO_TORCH_TELEMETRY`` (``off`` |
``counters`` [default] | ``spans``): under ``off`` every instrument site
is a branch-and-return no-op, and outside ``spans`` no span records a
CUDA event or waits for the card (:mod:`repro_torch.telemetry.config`).

    from repro_torch import telemetry as T

    T.set_mode("spans")
    pyr = dwt2(x, levels=3, fuse="pyramid")
    T.write_chrome_trace("trace.json")       # -> ui.perfetto.dev
    print(T.prometheus_text())               # -> any Prometheus scraper
"""
from repro_torch.telemetry.attribution import (clear_pending,
                                               plan_cost_inputs, plan_macs,
                                               record_execution, record_span,
                                               resolve_pending, roofline)
from repro_torch.telemetry.config import (CONFIG, DEFAULT_MODE, MODE_ENV,
                                          MODES, mode, reload, set_mode)
from repro_torch.telemetry.export import (chrome_trace, parse_prometheus_text,
                                          prometheus_text, write_chrome_trace)
from repro_torch.telemetry.registry import (DEFAULT_BUCKETS, MAX_SERIES,
                                            REGISTRY, Counter, CounterAlias,
                                            Gauge, Histogram, MetricsRegistry)
from repro_torch.telemetry.spans import (NOOP_SPAN, TRACER, SpanRecord,
                                         SpanTracer, current_span,
                                         device_span, span, span_summary,
                                         synchronising_calls)

__all__ = [
    # config
    "mode", "set_mode", "reload", "MODES", "MODE_ENV", "DEFAULT_MODE",
    "CONFIG",
    # registry
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "CounterAlias", "MAX_SERIES", "DEFAULT_BUCKETS",
    "counter", "gauge", "histogram", "snapshot", "reset", "stats",
    # spans
    "span", "device_span", "current_span", "span_summary", "SpanTracer",
    "SpanRecord", "TRACER", "NOOP_SPAN", "synchronising_calls",
    # export
    "prometheus_text", "parse_prometheus_text", "chrome_trace",
    "write_chrome_trace",
    # attribution
    "record_execution", "record_span", "resolve_pending",
    "plan_cost_inputs", "plan_macs", "roofline",
]


def counter(name: str, help: str = "", labelnames=None,
            gated: bool = True) -> Counter:
    """Get-or-create a counter on the global registry (``gated=False``:
    it counts in every telemetry mode)."""
    return REGISTRY.counter(name, help=help, labelnames=labelnames,
                            gated=gated)


def gauge(name: str, help: str = "", labelnames=None) -> Gauge:
    """Get-or-create a gauge on the global registry."""
    return REGISTRY.gauge(name, help=help, labelnames=labelnames)


def histogram(name: str, help: str = "", labelnames=None,
              buckets=DEFAULT_BUCKETS) -> Histogram:
    """Get-or-create a histogram on the global registry."""
    return REGISTRY.histogram(name, help=help, labelnames=labelnames,
                              buckets=buckets)


def snapshot() -> dict:
    """Nested-dict snapshot of every metric on the global registry."""
    resolve_pending()
    return REGISTRY.snapshot()


def reset() -> None:
    """Zero every metric series and clear the span ring (per-test
    isolation; metric definitions survive)."""
    REGISTRY.reset()
    TRACER.clear()
    clear_pending()


def stats() -> dict:
    """The ``engine.stats()["telemetry"]`` section: active mode, metric
    and series counts, span-ring accounting."""
    n_series = sum(len(m._series) for m in REGISTRY)
    return {"mode": mode(), "metrics": len(REGISTRY),
            "series": n_series,
            "dropped_series": REGISTRY.dropped_series,
            "spans": TRACER.stats()}
