"""LRU cache of compiled :class:`~repro_torch.engine.plan.DwtPlan` objects.

``get_plan(...)`` is the engine's front door: it normalizes the arguments
into a :class:`~repro_torch.engine.plan.PlanKey` (device included) and
returns a shared plan, building one only on a miss.  Hit/miss counters
let callers verify that repeated same-shape traffic pays zero rebuild
cost.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional, Tuple

from repro_torch.engine.plan import (DwtPlan, PlanKey, build_plan,
                                     resolve_device)


class PlanCache:
    """Thread-safe LRU mapping PlanKey -> DwtPlan with hit/miss counters."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._plans: "OrderedDict[PlanKey, DwtPlan]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: PlanKey,
            build: Callable[[PlanKey], DwtPlan] = build_plan) -> DwtPlan:
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
                return plan
        # build outside the lock: scheme algebra + compilation can be slow
        plan = build(key)
        with self._lock:
            if key in self._plans:      # a racing build won; reuse it
                self.hits += 1
                return self._plans[key]
            self.misses += 1
            self._plans[key] = plan
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
            return plan

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._plans), "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = 0
            self.misses = 0


_GLOBAL = PlanCache()


def get_plan(*, wavelet: str = "cdf97", scheme: str = "ns-polyconv",
             levels: int = 1, shape: Tuple[int, ...], dtype: str = "float32",
             backend: str = "cuda", optimize: bool = False,
             fuse: str = "none", boundary: str = "periodic",
             compute_dtype: str = "float32", tap_opt: str = "full",
             device="cuda", tiles: Optional[Tuple[int, int]] = None,
             packet=None, ndim: int = 2,
             cache: Optional[PlanCache] = None) -> DwtPlan:
    """Fetch (or build) the plan for one transform configuration.

    ``device`` is part of the key (``"cuda"`` resolves to the current
    CUDA device and raises when there is none).  ``cache=None`` uses the
    process-global LRU; pass an explicit :class:`PlanCache` for
    isolation.

    >>> from repro_torch.engine import PlanCache, get_plan
    >>> cache = PlanCache()
    >>> plan = get_plan(shape=(8, 64, 64), levels=2, scheme="ns-polyconv",
    ...                 backend="cuda", fuse="none", device="cpu",
    ...                 cache=cache)
    >>> plan.num_steps, plan.launches   # 2 barrier steps/level x 2 levels
    (4, 4)
    >>> get_plan(shape=(8, 64, 64), levels=2, scheme="ns-polyconv",
    ...          backend="cuda", fuse="none", device="cpu",
    ...          cache=cache) is plan
    True
    >>> cache.stats()["hits"], cache.stats()["misses"]
    (1, 1)
    """
    key = PlanKey(wavelet=wavelet, scheme=scheme, levels=int(levels),
                  shape=tuple(int(d) for d in shape), dtype=str(dtype),
                  backend=backend, optimize=bool(optimize), fuse=fuse,
                  boundary=boundary, compute_dtype=str(compute_dtype),
                  tap_opt=tap_opt, device=str(resolve_device(device)),
                  tiles=(None if tiles is None
                         else (int(tiles[0]), int(tiles[1]))),
                  packet=None if packet is None else packet,
                  ndim=int(ndim))
    # explicit None check: an empty PlanCache is falsy (__len__ == 0)
    return (_GLOBAL if cache is None else cache).get(key)


def plan_cache_stats() -> dict:
    return _GLOBAL.stats()


def clear_plan_cache() -> None:
    _GLOBAL.clear()
