"""Plan/executor engine: cached :class:`DwtPlan` objects resolved from a
:class:`PlanKey`, executed on a registered backend (``"torch"``,
``"cuda"`` or ``"conv"``) through the resilience plane
(:mod:`repro_torch.faults`).  ``PYRAMID_COUNTERS`` counts fused-pyramid
executions and shared-memory fallbacks to ``fuse="levels"``;
``WORKLOAD_COUNTERS`` counts packet and 3-D plans demoted from
``fuse="pyramid"`` to ``"levels"`` (both views over the telemetry
registry); :func:`stats` is the engine-wide summary."""
from repro_torch.engine.backends import (Backend, BackendError,
                                         available_backends,
                                         capability_matrix, get_backend,
                                         register_backend)
from repro_torch.engine.cache import (PlanCache, clear_plan_cache,
                                      get_plan, plan_cache_stats, stats)
from repro_torch.engine.plan import COUNTERS as PYRAMID_COUNTERS
from repro_torch.engine.plan import (WORKLOAD_COUNTERS, DwtPlan, LevelSpec,
                                     PlanKey, PyramidSpec, build_plan,
                                     canonical_key, resolve_device,
                                     validate_image_geometry)
from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D

__all__ = ["Backend", "BackendError", "DwtPlan", "LevelSpec", "PlanCache",
           "PlanKey", "PYRAMID_COUNTERS", "Pyramid", "Pyramid3",
           "PyramidSpec", "WORKLOAD_COUNTERS", "WaveletPacket2D",
           "available_backends", "build_plan", "canonical_key",
           "capability_matrix",
           "clear_plan_cache", "get_backend", "get_plan", "plan_cache_stats",
           "register_backend", "resolve_device", "stats",
           "validate_image_geometry"]
