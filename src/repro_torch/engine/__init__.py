"""Plan/executor engine: cached :class:`DwtPlan` objects resolved from a
:class:`PlanKey`, executed on a registered backend (``"torch"`` or
``"cuda"``)."""
from repro_torch.engine.backends import (Backend, BackendError,
                                         available_backends, get_backend,
                                         register_backend)
from repro_torch.engine.cache import (PlanCache, clear_plan_cache,
                                      get_plan, plan_cache_stats)
from repro_torch.engine.plan import (DwtPlan, LevelSpec, PlanKey,
                                     build_plan, resolve_device,
                                     validate_image_geometry)
from repro_torch.engine.pyramid import Pyramid

__all__ = ["Backend", "BackendError", "DwtPlan", "LevelSpec", "PlanCache",
           "PlanKey", "Pyramid", "available_backends", "build_plan",
           "clear_plan_cache", "get_backend", "get_plan", "plan_cache_stats",
           "register_backend", "resolve_device", "validate_image_geometry"]
