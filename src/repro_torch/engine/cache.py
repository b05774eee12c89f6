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

from repro_torch import telemetry as T
from repro_torch.engine.plan import (DwtPlan, PlanKey, build_plan,
                                     canonical_key, resolve_device)

# process-wide cache traffic (every PlanCache instance records here;
# instances also keep their own hit/miss ints for isolated .stats())
CACHE_LOOKUPS = T.counter(
    "repro_plan_cache_lookups_total",
    "plan-cache lookups by result", labelnames=("result", "backend"))


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
        key = canonical_key(key)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
                CACHE_LOOKUPS.inc(result="hit", backend=key.backend)
                return plan
        # build outside the lock: scheme algebra + compilation can be slow
        with T.span("plan.cache_miss", backend=key.backend, fuse=key.fuse,
                    scheme=key.scheme):
            plan = build(key)
        with self._lock:
            if key in self._plans:      # a racing build won; reuse it
                self.hits += 1
                CACHE_LOOKUPS.inc(result="hit", backend=key.backend)
                return self._plans[key]
            self.misses += 1
            CACHE_LOOKUPS.inc(result="miss", backend=key.backend)
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


def global_cache() -> PlanCache:
    return _GLOBAL


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

    ``packet`` accepts anything
    :meth:`repro_torch.core.packets.PacketTree.from_spec` does (a
    PacketTree, ``"full:D"`` / ``"dwt:L"``, or leaf paths); it is
    normalized to the canonical leaf tuple — so every admissible spelling
    of the same tree shares one cached plan — and ``levels`` is
    overridden by the tree depth.  ``ndim=3`` keys the t+2D volume
    transform over ``(..., T, H, W)``.

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
    >>> pk = get_plan(shape=(64, 64), packet="full:2", device="cpu",
    ...               cache=cache)
    >>> pk.key.levels, len(pk.key.packet), pk.launches  # 5 nodes, 2 steps
    (2, 16, 10)
    >>> get_plan(shape=(64, 64), packet=pk.key.packet, device="cpu",
    ...          cache=cache) is pk               # same tree, spelled out
    True
    """
    if packet is not None:
        from repro_torch.core import packets as PK
        tree = PK.PacketTree.from_spec(packet)
        packet = tree.leaves
        levels = tree.depth
    key = PlanKey(wavelet=wavelet, scheme=scheme, levels=int(levels),
                  shape=tuple(int(d) for d in shape), dtype=str(dtype),
                  backend=backend, optimize=bool(optimize), fuse=fuse,
                  boundary=boundary, compute_dtype=str(compute_dtype),
                  tap_opt=tap_opt, device=str(resolve_device(device)),
                  tiles=(None if tiles is None
                         else (int(tiles[0]), int(tiles[1]))),
                  packet=packet,
                  ndim=int(ndim))
    # explicit None check: an empty PlanCache is falsy (__len__ == 0)
    return (_GLOBAL if cache is None else cache).get(key)


def plan_cache_stats() -> dict:
    return _GLOBAL.stats()


def clear_plan_cache() -> None:
    _GLOBAL.clear()


def _plan_row(key: PlanKey, plan: DwtPlan) -> dict:
    row = {"wavelet": key.wavelet, "scheme": key.scheme,
           "levels": key.levels, "shape": key.shape,
           "backend": key.backend, "fuse": key.fuse,
           "optimize": key.optimize, "tap_opt": key.tap_opt,
           "num_steps": plan.num_steps, "launches": plan.launches}
    compiled = plan.compiled_stats()
    if compiled is not None:
        row["compiled_macs"] = compiled["macs"]
        row["compiled_nodes"] = compiled["nodes"]
        row["compiled_halo"] = compiled["halo"]
    if plan.grid is not None:
        row["tiles"] = key.tiles
        row["tile_count"] = plan.tile_count
        row["tile_grid"] = plan.grid.grid_shape
        row["halo_margin"] = plan.grid.margin
    if plan.pyramid is not None:
        spec = plan.pyramid
        halo = spec.fwd_kernel.programs[0].halo
        row["pyramid_block"] = spec.block
        # level 0's forward window in image space (each level of the
        # port's kernels walks its own tile and halo)
        row["pyramid_window"] = (spec.block[0] + 4 * halo,
                                 spec.block[1] + 4 * halo)
        row["pyramid_smem_bytes"] = spec.smem_bytes
    if key.packet is not None:
        row["packet_leaves"] = len(key.packet)
        row["packet_depth"] = key.levels
    if key.ndim != 2:
        row["ndim"] = key.ndim
    if plan.fallback is not None:
        row["fallback"] = plan.fallback
    if plan.auto is not None:
        # the cache key says backend="auto"; the plan key carries the
        # concrete resolution
        row["auto"] = {"backend": plan.key.backend, "fuse": plan.key.fuse,
                       "tap_opt": plan.key.tap_opt,
                       "source": plan.auto.source,
                       "predicted_s": plan.auto.predicted_s}
    return row


def stats() -> dict:
    """Engine-wide observability summary, in the reference's schema:
    plan-cache hit/miss counters, the fault plane and its policies
    (:mod:`repro_torch.faults`), fused-pyramid counters (executions,
    shared-memory fallbacks — ``vmem_fallbacks``, the reference's key and
    metric), ``backend="auto"`` resolutions by source and the chosen
    configurations (:mod:`repro_torch.profiler`), block-table
    device-mismatch fallbacks and the table's path
    (:mod:`repro_torch.engine.autotune`), the registered-backend
    capability matrix, serving counters — p50/p99 request latency,
    served img/s, batch occupancy, backpressure and re-dispatch counts
    (:mod:`repro_torch.serve`) — the telemetry registry/span-ring
    accounting (:mod:`repro_torch.telemetry`), plus one row per cached
    plan (steps, kernel launches, compiled tap-program op counts, tile
    grid, pyramid geometry, the ``auto`` resolution).  A tiled plan's
    ``launches`` are its window plan's, which the row reads through the
    plan cache.  In a plan row, the reference's ``pallas_calls`` is
    ``launches`` and ``pyramid_vmem_bytes`` is ``pyramid_smem_bytes``.
    Every section is read live; a section whose read fails raises (a
    zeroed section would hide what it counts).

    >>> from repro_torch import engine
    >>> s = engine.stats()
    >>> sorted(s)
    ['auto', 'backends', 'block_table', 'faults', 'plan_cache', 'plans', 'pyramid', 'serve', 'telemetry']
    >>> [row["backend"] for row in s["backends"]]
    ['auto', 'conv', 'cuda', 'torch']
    >>> sorted(s["auto"])
    ['choices', 'cold_fallbacks', 'predictions', 'store_hits']
    >>> sorted(s["pyramid"])
    ['pyramid_kernel_launches', 'vmem_fallbacks']
    """
    from repro_torch import faults as F
    from repro_torch.engine import autotune as AT
    from repro_torch.engine import backends as B
    from repro_torch.engine import plan as P
    from repro_torch.profiler import auto as PA  # profiler -> engine
    from repro_torch.serve import metrics as SM
    with _GLOBAL._lock:
        items = list(_GLOBAL._plans.items())
    return {"plan_cache": _GLOBAL.stats(),
            "faults": F.stats(),
            "pyramid": {"pyramid_kernel_launches":
                        P.COUNTERS["pyramid_kernel_launches"],
                        "vmem_fallbacks": P.COUNTERS["smem_fallbacks"]},
            "auto": PA.auto_stats(),
            "block_table": {"device_fallbacks":
                            AT.COUNTERS["device_fallbacks"],
                            "path": str(AT.table_path())},
            "backends": list(B.capability_matrix()),
            "serve": SM.serve_stats(),
            "telemetry": T.stats(),
            "plans": [_plan_row(key, plan) for key, plan in items]}
