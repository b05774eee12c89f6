"""Central metrics registry: named counters, gauges, bucketed histograms.

One process-global :class:`MetricsRegistry` (``REGISTRY``) holds every
metric the port records — plan-cache traffic, plan builds and
executions, fused-pyramid launches and shared-memory fallbacks, fault
injections, retries and fallbacks, achieved-GB/s gauges.  The metric
names are the reference package's (``repro_*``), so one dashboard reads
either package.  The engine's older dict counters
(``engine.PYRAMID_COUNTERS``, ``engine.WORKLOAD_COUNTERS``) are
:class:`CounterAlias` views over it.

Design points:

* **labels** — every observation carries a label set
  (``counter.inc(backend="cuda", fuse="levels")``); each distinct sorted
  label tuple is one series.  Metrics may declare ``labelnames`` to
  reject typo'd label sets at the call site; undeclared metrics accept
  any labels.  A per-metric series cap (:data:`MAX_SERIES`) guards
  against unbounded cardinality — excess series are dropped and counted.
* **thread-safe** — one registry lock around every mutation.
* **mode-gated** — writes are no-ops under ``REPRO_TORCH_TELEMETRY=off``
  (:mod:`repro_torch.telemetry.config`); reads always work.  A counter
  declared ``gated=False`` counts in every mode: the engine's record of
  what it did rather than observability — degradation-chain fallbacks,
  fused-pyramid executions and shared-memory fallbacks, workload fuse
  demotions (the engine's dict counters counted in every mode before
  they became registry views, and a fallback must never go unseen);
* **snapshot / reset** — :meth:`MetricsRegistry.snapshot` returns the
  nested-dict view; :meth:`MetricsRegistry.reset` zeroes every series
  for test isolation without dropping metric definitions.

Prometheus text exposition lives in :mod:`repro_torch.telemetry.export`.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.telemetry.config import CONFIG

#: per-metric bound on distinct label sets; observations beyond it are
#: dropped (and counted in ``registry.dropped_series``), never raised —
#: telemetry must not take the hot path down
MAX_SERIES = 1024

#: default histogram upper bounds (seconds-flavored, roughly log-spaced
#: from 50 us to 30 s; +Inf is implicit)
DEFAULT_BUCKETS = (5e-5, 2e-4, 1e-3, 5e-3, 2e-2, 0.1, 0.5, 2.0, 10.0, 30.0)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: dict) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base class: one named metric holding many labeled series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str = "",
                 labelnames: Optional[Sequence[str]] = None):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames) if labelnames else None
        self._registry = registry
        self._series: Dict[LabelsKey, object] = {}

    def _key(self, labels: dict) -> Optional[LabelsKey]:
        """Resolve (and admit) one label set; None = dropped (declared
        label mismatch or series-cap overflow)."""
        if self.labelnames is not None and \
                tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} declares labels "
                f"{tuple(sorted(self.labelnames))}, got "
                f"{tuple(sorted(labels))}")
        k = _labels_key(labels)
        if k not in self._series and len(self._series) >= MAX_SERIES:
            self._registry.dropped_series += 1
            return None
        return k

    # -- reading (never mode-gated) ------------------------------------
    def value(self, **labels) -> float:
        """Current value of one series (0.0 when it never recorded)."""
        with self._registry._lock:
            v = self._series.get(_labels_key(labels))
            return float(v) if v is not None else 0.0

    def series(self) -> List[dict]:
        """Snapshot rows: ``[{"labels": {...}, "value": v}, ...]``."""
        with self._registry._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())]

    def _snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help,
                "series": self.series()}

    def _reset(self) -> None:
        self._series.clear()

    def reset(self) -> None:
        """Drop every series of this one metric (definition survives) —
        finer-grained than :meth:`MetricsRegistry.reset`."""
        with self._registry._lock:
            self._reset()


class Counter(Metric):
    """Monotonically-increasing count (Prometheus counter); ``gated=False``
    counts whatever the telemetry mode."""

    kind = "counter"

    def __init__(self, registry, name, help="", labelnames=None,
                 gated: bool = True):
        super().__init__(registry, name, help, labelnames)
        self.gated = gated

    def inc(self, n: float = 1, **labels) -> None:
        if self.gated and not CONFIG.counters_on:
            return
        with self._registry._lock:
            k = self._key(labels)
            if k is not None:
                self._series[k] = self._series.get(k, 0) + n

    def force_set(self, v: float, **labels) -> None:
        """Deprecated-alias write path (``COUNTERS["x"] = v``): sets the
        series total directly, regardless of telemetry mode."""
        with self._registry._lock:
            k = self._key(labels)
            if k is not None:
                self._series[k] = v


class Gauge(Metric):
    """Last-write-wins instantaneous value (Prometheus gauge)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        if not CONFIG.counters_on:
            return
        with self._registry._lock:
            k = self._key(labels)
            if k is not None:
                self._series[k] = float(v)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)   # +1 = the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def __float__(self) -> float:            # Metric.value() -> count
        return float(self.count)


class Histogram(Metric):
    """Bucketed distribution (Prometheus histogram: cumulative
    ``_bucket{le=...}`` series plus ``_sum`` / ``_count``)."""

    kind = "histogram"

    def __init__(self, registry, name, help="", labelnames=None,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, v: float, **labels) -> None:
        if not CONFIG.counters_on:
            return
        with self._registry._lock:
            k = self._key(labels)
            if k is None:
                return
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets))
            i = 0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.sum += v
            s.count += 1

    def series(self) -> List[dict]:
        with self._registry._lock:
            out = []
            for k, s in sorted(self._series.items(),
                               key=lambda kv: kv[0]):
                cum, buckets = 0, {}
                for ub, c in zip(self.buckets, s.counts):
                    cum += c
                    buckets[ub] = cum
                out.append({"labels": dict(k), "buckets": buckets,
                            "sum": s.sum, "count": s.count,
                            "value": s.count})
            return out


class MetricsRegistry:
    """Registry of named metrics: get-or-create accessors, snapshot,
    reset.  One process-global instance (:data:`REGISTRY`) backs the
    whole stack; tests may build private registries for isolation."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "Dict[str, Metric]" = {}
        self.dropped_series = 0

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help=help,
                                              labelnames=labelnames, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Optional[Sequence[str]] = None,
                gated: bool = True) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   gated=gated)

    def gauge(self, name: str, help: str = "",
              labelnames: Optional[Sequence[str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Optional[Sequence[str]] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def __iter__(self) -> Iterator[Metric]:
        with self._lock:
            metrics = list(self._metrics.values())
        return iter(sorted(metrics, key=lambda m: m.name))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Nested-dict view of every metric: ``{name: {type, help,
        series: [...]}}``."""
        return {m.name: m._snapshot() for m in self}

    def reset(self) -> None:
        """Zero every series (metric definitions survive) — per-test
        isolation, mirroring the old ``COUNTERS.update(x=0)`` idiom."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()
            self.dropped_series = 0


#: the process-global registry every instrument site records into
REGISTRY = MetricsRegistry()


class CounterAlias:
    """Dict-style view over registry counters.

    Keeps the engine's older dict counters alive on top of the registry:
    ``engine.PYRAMID_COUNTERS["smem_fallbacks"]``,
    ``dict(engine.WORKLOAD_COUNTERS)`` and ``alias.update(...)`` read and
    write the central registry.  ``mapping`` maps each key to
    ``(metric_name, labels)``; a read sums every series of the metric
    whose labels include ``labels`` (so a key may leave out a label, as
    ``WORKLOAD_COUNTERS["packet"]`` leaves out the backend), a write sets
    the one series with exactly ``labels``.  Writes through the alias
    bypass the ``REPRO_TORCH_TELEMETRY=off`` gate (they exist for callers
    that reset or seed a counter, never on the hot path).
    """

    def __init__(self, mapping: Dict[str, Tuple[str, dict]],
                 registry: MetricsRegistry = REGISTRY):
        self._mapping = dict(mapping)
        self._registry = registry

    def _counter(self, key: str) -> Tuple[Counter, dict]:
        name, labels = self._mapping[key]
        return self._registry.counter(name), labels

    def __getitem__(self, key: str) -> float:
        c, labels = self._counter(key)
        want = set(_labels_key(labels))
        with self._registry._lock:
            v = sum(float(s) for k, s in c._series.items()
                    if want <= set(k))
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, key: str, value) -> None:
        c, labels = self._counter(key)
        c.force_set(value, **labels)

    def __iter__(self):
        return iter(self._mapping)

    def __len__(self) -> int:
        return len(self._mapping)

    def __contains__(self, key) -> bool:
        return key in self._mapping

    def __eq__(self, other) -> bool:
        try:
            return dict(self.items()) == dict(other)
        except (TypeError, ValueError):
            return NotImplemented

    __hash__ = None

    def keys(self):
        return self._mapping.keys()

    def values(self):
        return [self[k] for k in self._mapping]

    def items(self):
        return [(k, self[k]) for k in self._mapping]

    def update(self, other=(), **kw) -> None:
        for k, v in dict(other, **kw).items():
            self[k] = v

    def __repr__(self) -> str:
        return f"CounterAlias({dict(self.items())!r})"
