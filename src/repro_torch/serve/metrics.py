"""Serving counters: latency percentiles, throughput, batch occupancy.

Every serving counter lives on the port's telemetry registry
(:mod:`repro_torch.telemetry`) under the reference package's series
names — ``repro_serve_requests_total`` (labelled by event),
batch/padding/worker counters and a request latency histogram — so one
Prometheus scrape covers serving next to the engine and kernel metrics.
This module keeps the recording facade (:class:`ServeMetrics`) the
scheduler pushes into and the ``snapshot()`` schema of
``repro_torch.engine.stats()["serve"]``, the reference's.

Percentiles come from a bounded window of raw latencies (newest
:data:`LATENCY_WINDOW` samples; a long-lived server never grows without
limit).  Samples evicted from the window are *counted*
(``latency_dropped``) so a dashboard can tell "p99 over everything"
from "p99 over the last 8192 requests".

All numbers describe the *current process* since the last
:func:`reset` — what a production dashboard scrapes per replica.
Imports only :mod:`repro_torch.telemetry` (itself a leaf), so
``repro_torch.engine.stats()`` can pull the ``"serve"`` section without
an import cycle.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from repro_torch import telemetry as T

#: retained request latencies (newest wins) for the percentile estimate
LATENCY_WINDOW = 8192

REQUESTS = T.counter(
    "repro_serve_requests_total",
    "serving requests by lifecycle event (submitted / served / failed / "
    "rejected / redispatched)", labelnames=("event",))
BATCHES = T.counter(
    "repro_serve_batches_total", "coalesced batched plan executions")
PADDED_IMAGES = T.counter(
    "repro_serve_padded_images_total",
    "zero-padding images executed to round batches up to bucket sizes")
WORKER_DEATHS = T.counter(
    "repro_serve_worker_deaths_total", "device-worker deaths")
WORKERS_SPAWNED = T.counter(
    "repro_serve_workers_spawned_total",
    "elastic replacement workers started")
LATENCY = T.histogram(
    "repro_serve_request_latency_seconds",
    "request latency, submit -> scattered result")
LATENCY_DROPPED = T.counter(
    "repro_serve_latency_samples_dropped_total",
    "raw latency samples evicted from the bounded percentile window")
DEADLINE_EXCEEDED = T.counter(
    "repro_serve_deadline_exceeded_total",
    "requests failed by their per-request deadline "
    "(ServeConfig.request_deadline_ms)")
QUARANTINED = T.counter(
    "repro_serve_quarantined_requests_total",
    "requests re-dispatched as isolated singleton batches after their "
    "batch killed more than one worker (poison-batch quarantine)")
BREAKER_REJECTIONS = T.counter(
    "repro_serve_breaker_rejections_total",
    "requests fast-failed because their bucket's circuit breaker was "
    "open")


def _quantile(sorted_vals, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


class ServeMetrics:
    """Thread-safe serving counters (workers scatter from the event loop,
    but benches/tests may read from other threads).  Counts land on the
    telemetry registry; this class adds the percentile window and the
    throughput timestamps the registry does not model."""

    _METRICS = (REQUESTS, BATCHES, PADDED_IMAGES, WORKER_DEATHS,
                WORKERS_SPAWNED, LATENCY, LATENCY_DROPPED,
                DEADLINE_EXCEEDED, QUARANTINED, BREAKER_REJECTIONS)

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for m in self._METRICS:
                m.reset()
            self._occupancy_sum = 0.0
            self._lat_s = deque(maxlen=LATENCY_WINDOW)
            self._first_ts: Optional[float] = None
            self._last_ts: Optional[float] = None

    # -- registry-backed reads (attribute API kept for back-compat) ----
    @property
    def submitted(self) -> int:
        return int(REQUESTS.value(event="submitted"))

    @property
    def served(self) -> int:
        return int(REQUESTS.value(event="served"))

    @property
    def failed(self) -> int:
        return int(REQUESTS.value(event="failed"))

    @property
    def rejected(self) -> int:
        return int(REQUESTS.value(event="rejected"))

    @property
    def redispatched(self) -> int:
        return int(REQUESTS.value(event="redispatched"))

    @property
    def batches(self) -> int:
        return int(BATCHES.value())

    @property
    def padded_images(self) -> int:
        return int(PADDED_IMAGES.value())

    @property
    def worker_deaths(self) -> int:
        return int(WORKER_DEATHS.value())

    @property
    def workers_spawned(self) -> int:
        return int(WORKERS_SPAWNED.value())

    # -- recording hooks (called by the scheduler) ---------------------
    def request_submitted(self, n: int = 1) -> None:
        REQUESTS.inc(n, event="submitted")
        with self._lock:
            if self._first_ts is None:
                self._first_ts = time.perf_counter()

    def request_rejected(self, n: int = 1) -> None:
        REQUESTS.inc(n, event="rejected")

    def request_failed(self, n: int = 1) -> None:
        REQUESTS.inc(n, event="failed")

    def batch_done(self, real: int, padded: int, latencies_s) -> None:
        latencies_s = list(latencies_s)
        REQUESTS.inc(real, event="served")
        BATCHES.inc()
        PADDED_IMAGES.inc(max(0, padded - real))
        for lat in latencies_s:
            LATENCY.observe(lat)
        with self._lock:
            self._occupancy_sum += real / max(1, padded)
            evicted = max(0, len(self._lat_s) + len(latencies_s)
                          - LATENCY_WINDOW)
            if evicted:
                LATENCY_DROPPED.inc(evicted)
            self._lat_s.extend(latencies_s)
            self._last_ts = time.perf_counter()

    def worker_died(self, redispatched: int) -> None:
        WORKER_DEATHS.inc()
        REQUESTS.inc(redispatched, event="redispatched")

    def worker_spawned(self) -> None:
        WORKERS_SPAWNED.inc()

    def deadline_exceeded(self, n: int = 1) -> None:
        DEADLINE_EXCEEDED.inc(n)
        REQUESTS.inc(n, event="failed")

    def quarantined(self, n: int = 1) -> None:
        QUARANTINED.inc(n)

    def breaker_rejected(self, n: int = 1) -> None:
        BREAKER_REJECTIONS.inc(n)

    # -- reading -------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``engine.stats()["serve"]`` payload: request/batch
        counters, p50/p99 request latency (submit -> result, ms) over
        the bounded window plus its drop accounting, measured served
        img/s over the active window, and the mean batch occupancy
        (real images / padded batch size)."""
        with self._lock:
            lat = sorted(self._lat_s)
            span = ((self._last_ts - self._first_ts)
                    if self._first_ts is not None
                    and self._last_ts is not None else 0.0)
            occupancy = self._occupancy_sum
        batches = self.batches
        served = self.served
        return {
            "submitted": self.submitted,
            "served": served,
            "failed": self.failed,
            "rejected": self.rejected,
            "redispatched": self.redispatched,
            "worker_deaths": self.worker_deaths,
            "workers_spawned": self.workers_spawned,
            "batches": batches,
            "padded_images": self.padded_images,
            "mean_occupancy": (occupancy / batches if batches else None),
            "deadline_exceeded": int(DEADLINE_EXCEEDED.value()),
            "quarantined": int(QUARANTINED.value()),
            "breaker_rejections": int(BREAKER_REJECTIONS.value()),
            "latency_samples": len(lat),
            "latency_dropped": int(LATENCY_DROPPED.value()),
            "p50_ms": (_quantile(lat, 0.50) * 1e3 if lat else None),
            "p99_ms": (_quantile(lat, 0.99) * 1e3 if lat else None),
            "img_per_s": (served / span if span > 0 else None),
        }


#: process-global singleton (one serving runtime per process is the
#: expected deployment shape; tests reset() between cases)
METRICS = ServeMetrics()


def serve_stats() -> dict:
    return METRICS.snapshot()


def reset() -> None:
    METRICS.reset()
