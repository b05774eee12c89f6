"""PyTorch/CUDA port of the multi-level 2-D DWT engine.

The same plan cache, scheme algebra and tap-program compiler as the
reference package, executed by a torch reference backend (``"torch"``)
and by a hand-written CUDA window kernel (``"cuda"``,
:mod:`repro_torch.kernels.tap_window`).  Entry points run on the card
unless the caller passes ``device="cpu"``.

    >>> import torch, repro_torch
    >>> pyr = repro_torch.dwt2(torch.ones(16, 16), levels=2, device="cpu")
    >>> tuple(pyr.ll.shape)
    (4, 4)
"""
from repro_torch.core.transform import dwt2, idwt2, validate_finite
from repro_torch.engine import (BackendError, DwtPlan, PlanCache, PlanKey,
                                Pyramid, available_backends,
                                clear_plan_cache, get_plan,
                                plan_cache_stats)

__all__ = ["BackendError", "DwtPlan", "PlanCache", "PlanKey", "Pyramid",
           "available_backends", "clear_plan_cache", "dwt2", "get_plan",
           "idwt2", "plan_cache_stats", "validate_finite"]
