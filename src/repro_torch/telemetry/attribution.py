"""Efficiency attribution: join measured time with the analytic models.

The port models, per plan, the two quantities the paper's measurement
argument is built on — device-memory bytes moved and in-kernel MACs —
through its executor (``plan.executor.hbm_bytes``, the same model the
chip script divides by, and ``plan.executor.macs``).  This module
divides a measured time by them and publishes the quotients as gauges:

* ``repro_achieved_gbps``       — modelled bytes / measured seconds,
* ``repro_achieved_macs_per_s`` — compiled MACs / measured seconds,
* ``repro_measured_seconds``    — the raw measurement,

* ``repro_model_time_ratio``   — measured / cost-model-predicted
  seconds, for plans resolved from ``backend="auto"``
  (:mod:`repro_torch.profiler.auto`),

all labelled ``(scheme, backend, fuse, levels, op)`` — a live roofline
per plan.  The metric names are the reference package's.

The caller is the engine's ``execute.*`` span under
``REPRO_TORCH_TELEMETRY=spans`` (:func:`record_span`): on a CUDA plan
that span is timed on the card
(:func:`repro_torch.telemetry.spans.device_span`), so the gauge divides
by device time, not by the host time of an asynchronous launch.  Such a
record is not resolved when the execution returns, which would wait for
the card on every execution: the newest record of each series waits in
:data:`_PENDING` until :func:`resolve_pending` — which :func:`roofline`
and the exports call — publishes it.  Attribution inputs are computed
once per plan and direction and cached on the plan object, so the
per-execution cost is two divisions and two gauge writes.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.telemetry.config import CONFIG
from repro_torch.telemetry.registry import REGISTRY

_ACHIEVED_GBPS = REGISTRY.gauge(
    "repro_achieved_gbps",
    "modeled HBM GB moved / measured second, per plan (live roofline)")
_ACHIEVED_MACS = REGISTRY.gauge(
    "repro_achieved_macs_per_s",
    "compiled tap-program MACs / measured second, per plan")
_MEASURED_S = REGISTRY.gauge(
    "repro_measured_seconds",
    "last measured wall-clock seconds per execution, per plan")
_MODEL_RATIO = REGISTRY.gauge(
    "repro_model_time_ratio",
    "measured / cost-model-predicted seconds (auto-resolved plans)")


def plan_macs(plan, op: str = "forward") -> Optional[int]:
    """Total compiled MACs of one ``op`` execution (all levels, every run
    of a level, batch included), or None when the plan walks raw
    matrices (``"torch"`` under ``tap_opt="off"``: no compiled programs
    to count).  A tiled plan's MACs are its window plan's (the halo
    recompute included)."""
    return plan.executor.macs(op)


def plan_cost_inputs(plan, op: str = "forward") -> Optional[dict]:
    """Analytic attribution inputs of one plan and direction — modelled
    device-memory bytes, modelled launches, compiled MACs — computed
    once and cached on the plan object (attribution runs per execution;
    the models must not)."""
    cache = plan.__dict__.setdefault("_attr_inputs", {})
    if op in cache:
        return cache[op] or None    # {} sentinel = "tried, failed"
    try:
        inputs = {"hbm_bytes": plan.executor.hbm_bytes(op),
                  "launches": plan.launches,
                  "macs": plan.executor.macs(op)}
    except Exception:
        # attribution is best-effort observability: a plan the analytic
        # models cannot featurize must not take execution down
        cache[op] = {}
        return None
    cache[op] = inputs
    return inputs


def _labels(plan, op: str) -> dict:
    k = plan.key
    return {"scheme": k.scheme, "backend": k.backend, "fuse": k.fuse,
            "levels": k.levels, "op": op}


def record_execution(plan, seconds: float, op: str = "forward"
                     ) -> Optional[dict]:
    """Publish achieved-GB/s / achieved-MACs/s gauges for one measured
    execution of ``plan``; returns the attribution row (or None when
    telemetry is off, the measurement is unusable, or the plan cannot
    be featurized)."""
    if not CONFIG.counters_on:
        return None
    return _publish(plan, seconds, op)


def _publish(plan, seconds: float, op: str) -> Optional[dict]:
    if not seconds or seconds <= 0:
        return None
    inputs = plan_cost_inputs(plan, op)
    if inputs is None:
        return None
    labels = _labels(plan, op)
    row = {**labels, "seconds": seconds,
           "hbm_bytes": inputs["hbm_bytes"],
           "macs": inputs["macs"],
           "gbps": inputs["hbm_bytes"] / seconds / 1e9,
           "macs_per_s": (inputs["macs"] / seconds
                          if inputs["macs"] is not None else None)}
    _MEASURED_S.set(seconds, **labels)
    _ACHIEVED_GBPS.set(row["gbps"], **labels)
    if row["macs_per_s"] is not None:
        _ACHIEVED_MACS.set(row["macs_per_s"], **labels)
    predicted = getattr(getattr(plan, "auto", None), "predicted_s", None)
    if predicted:
        row["model_time_ratio"] = seconds / predicted
        _MODEL_RATIO.set(row["model_time_ratio"], **labels)
    return row


#: executions timed on the card, not resolved yet: the newest span
#: record per series (a gauge keeps only the last value anyway)
_PENDING: dict = {}
_PENDING_LOCK = threading.Lock()


def record_span(plan, rec, op: str = "forward") -> None:
    """Attribute one execution of ``plan`` from its ``execute.*`` span
    record: at once when the span was timed on the host, at the next
    :func:`resolve_pending` when it was timed on the card (so nothing
    waits for the card here)."""
    if not CONFIG.counters_on:
        return
    if rec.clock != "cuda":
        _publish(plan, rec.dur_s, op)
        return
    key = tuple(sorted(_labels(plan, op).items()))
    with _PENDING_LOCK:
        _PENDING[key] = (plan, op, rec)


def resolve_pending() -> None:
    """Publish the gauges of every execution still timed on the card
    (waits for each one's end event)."""
    with _PENDING_LOCK:
        pending = list(_PENDING.values())
        _PENDING.clear()
    for plan, op, rec in pending:
        _publish(plan, rec.dur_s, op)


def clear_pending() -> None:
    """Drop the unresolved executions (per-test isolation)."""
    with _PENDING_LOCK:
        _PENDING.clear()


def roofline() -> list:
    """Current attribution rows, one per (plan-config, op) series that
    has recorded: the live measured-vs-modelled table."""
    resolve_pending()
    out = {}
    for metric, field in ((_MEASURED_S, "seconds"),
                          (_ACHIEVED_GBPS, "gbps"),
                          (_ACHIEVED_MACS, "macs_per_s"),
                          (_MODEL_RATIO, "model_time_ratio")):
        for s in metric.series():
            key = tuple(sorted(s["labels"].items()))
            out.setdefault(key, dict(s["labels"]))[field] = s["value"]
    return [out[k] for k in sorted(out)]
