"""Profile-guided plan selection: trace, fit, predict, auto-pick.

The measured feedback loop over the plan/executor engine:

* :mod:`repro_torch.profiler.store` — persistent JSONL trace store
  (``$REPRO_TORCH_PROFILE_STORE``; ``PROFILE_STORE_TORCH.jsonl`` at the
  root of the checkout by default), one :class:`TraceRecord` per
  measured plan, keyed by the plan configuration plus the fingerprint
  of the device it ran on, in the reference package's line format;
* :mod:`repro_torch.profiler.trace` — :func:`profile_plan` measures a
  built plan (kernels built and tables uploaded first) and persists the
  trace; :func:`warm_store` sweeps every valid ``(backend, fuse)``
  candidate of a configuration, :func:`warm_batches` every padded batch
  size of a serving bucket;
* :mod:`repro_torch.profiler.model` — :class:`CostModel`, a per-(backend,
  fuse, device) linear model over the port's modelled bytes and
  launches (:func:`config_features`) refined by nearest neighbours;
* :mod:`repro_torch.profiler.auto` — :func:`choose` resolves
  ``PlanKey(backend="auto")`` to a concrete ``(backend, fuse,
  block_target, tap_opt)``; the engine delegates to it at plan build
  (``dwt2(..., backend="auto")``).
"""
from repro_torch.profiler.auto import (AUTO_COUNTERS, AutoChoice, auto_stats,
                                       choose, enumerate_candidates,
                                       reset_counters)
from repro_torch.profiler.model import CostModel, config_features
from repro_torch.profiler.store import (STORE_ENV, TraceRecord, TraceStore,
                                        runtime_meta, store_path)
from repro_torch.profiler.trace import (measure_plan, measure_times,
                                        profile_plan, warm_batches,
                                        warm_store)

__all__ = [
    "TraceRecord", "TraceStore", "store_path", "runtime_meta", "STORE_ENV",
    "CostModel", "config_features",
    "measure_plan", "measure_times", "profile_plan", "warm_store",
    "warm_batches",
    "AutoChoice", "choose", "enumerate_candidates", "auto_stats",
    "reset_counters", "AUTO_COUNTERS",
]
