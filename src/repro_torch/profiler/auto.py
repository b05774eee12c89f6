"""``backend="auto"``: profile-guided plan selection.

No single calculation scheme or execution strategy wins everywhere: the
winner moves with the device, the image size and the scheme.
:func:`choose` turns that into engine behaviour.  At plan build, a
``PlanKey`` with ``backend="auto"`` is resolved to a concrete
``(backend, fuse, block_target, tap_opt)`` by, in order:

1. **store hit** — exact measured records of this configuration on the
   key's device pick the fastest measured candidate directly;
2. **model prediction** — the fitted cost model
   (:class:`~repro_torch.profiler.model.CostModel`) predicts wall-clock
   for every valid candidate from its features (modelled bytes +
   launches) and nearest measured neighbours;
3. **cold-start rule** — with no record of the device, a deterministic
   rule per device type (:func:`_heuristic`).

Every resolution is counted on the telemetry registry
(:data:`RESOLUTIONS`, labelled by source) and the chosen configurations
histogrammed (:data:`CHOICES`), surfaced through
``repro_torch.engine.stats()["auto"]`` with the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch import telemetry as T
from repro_torch.profiler import model as M
from repro_torch.profiler import store as ST

RESOLUTIONS = T.counter(
    "repro_auto_resolutions_total",
    'backend="auto" resolutions by source (store hit / model prediction '
    "/ cold-start heuristic)", labelnames=("source",))
CHOICES = T.counter(
    "repro_auto_choices_total",
    'concrete configurations backend="auto" resolved to',
    labelnames=("backend", "fuse"))

#: dict-style view of the resolution counter (the reference's alias and
#: keys)
AUTO_COUNTERS = T.CounterAlias({
    "predictions": ("repro_auto_resolutions_total", {"source": "model"}),
    "store_hits": ("repro_auto_resolutions_total", {"source": "store"}),
    "cold_fallbacks": ("repro_auto_resolutions_total",
                       {"source": "heuristic"}),
})


def reset_counters() -> None:
    RESOLUTIONS.reset()
    CHOICES.reset()


def auto_stats() -> dict:
    """The ``engine.stats()["auto"]`` section: resolutions served by
    model predictions, by exact store hits, by the cold-start rule, and
    the chosen-config histogram (``"backend|fuse"`` -> count)."""
    choices = {f'{s["labels"]["backend"]}|{s["labels"]["fuse"]}':
               int(s["value"]) for s in CHOICES.series()}
    return {**dict(AUTO_COUNTERS.items()),
            "choices": dict(sorted(choices.items()))}


@dataclasses.dataclass(frozen=True)
class AutoChoice:
    """The concrete configuration ``backend="auto"`` resolved to."""

    backend: str
    fuse: str
    tap_opt: str
    block: Optional[Tuple[int, int]]   # block target (None = table/default)
    source: str                        # "store" | "model" | "heuristic"
    predicted_s: Optional[float]       # measured (store) / predicted time


def enumerate_candidates(key) -> List[Tuple[str, str, str]]:
    """Every ``(backend, fuse, tap_opt)`` the registry can execute for
    this key (the choice space): what each backend's ``validate``
    accepts, so packet and 3-D keys have no ``"pyramid"`` and float64
    keys no ``"cuda"``.  ``tap_opt`` is pinned to ``"full"``; exact store
    records may still teach :func:`choose` another level."""
    from repro_torch.engine import backends as B
    cands = []
    for name in B.available_backends():
        if name == "auto":
            continue
        bk = B.get_backend(name)
        for fuse in bk.fuse_modes:
            trial = dataclasses.replace(key, backend=name, fuse=fuse,
                                        tap_opt="full")
            try:
                bk.validate(trial)
            except ValueError:
                continue
            cands.append((name, fuse, "full"))
    return cands


def _heuristic(key) -> AutoChoice:
    """Deterministic cold-start rule keyed on the key's device type.

    On a CUDA device: ``("cuda", "pyramid")`` for a multi-level key (else
    ``"levels"``), then ``("cuda", "levels")`` — from the port's H100
    measurements (PERF.md, NVIDIA H100 80GB HBM3, power limit 700 W):
    the ``"conv"`` path took 4.0x the ``"cuda"`` time, and a 3-level
    ``"pyramid"`` ``dwt2`` of 8 x 2048 x 2048 fp32 took 0.8904 ms against
    1.2051 ms at ``"levels"``.  The reference maps its GPU to
    ``("xla", "levels")``; the port does not.  Every device then falls
    through to ``("torch", "levels")`` and ``("torch", "none")``: on the
    CPU the rule gives ``("torch", "levels")``, the reference's
    ``("jnp", "levels")``."""
    import torch

    from repro_torch.engine import backends as B
    prefs = []
    if torch.device(key.device).type == "cuda":
        prefs = [("cuda", "pyramid" if key.levels > 1 else "levels"),
                 ("cuda", "levels")]
    prefs += [("torch", "levels"), ("torch", "none")]
    for name, fuse in prefs:
        try:
            B.get_backend(name).validate(
                dataclasses.replace(key, backend=name, fuse=fuse,
                                    tap_opt="full"))
        except ValueError:
            continue
        return AutoChoice(backend=name, fuse=fuse, tap_opt="full",
                          block=None, source="heuristic", predicted_s=None)
    raise ValueError(f"no registered backend can execute {key}")


def choose(key, store: Optional[ST.TraceStore] = None,
           block_target: Optional[Tuple[int, int]] = None) -> AutoChoice:
    """Resolve a ``backend="auto"`` key to a concrete configuration.

    Asks the persistent store first (exact measured records of this
    configuration on the key's device), then the fitted cost model, then
    the cold-start rule.  ``block_target`` (an explicit caller override)
    only suppresses the store's block annotation — the concrete plan
    build applies it either way.
    """
    from repro_torch.engine import autotune as AT
    if store is None:
        store = ST.TraceStore()
    device_recs = store.records(AT.device_fingerprint(key.device))
    exact = [r for r in device_recs if r.matches_key(key)]
    cands = enumerate_candidates(key)
    model = M.CostModel.fit(device_recs) if device_recs else None

    best = None         # (time_s, backend, fuse, tap_opt, block, source)
    for backend, fuse, tap_opt in cands:
        matches = [r for r in exact
                   if r.backend == backend and r.fuse == fuse]
        if matches:
            rec = min(matches, key=lambda r: (r.time_s, r.tap_opt))
            row = (rec.time_s, backend, fuse, rec.tap_opt, rec.block,
                   "store")
        elif model is not None and model.can_predict(backend, fuse):
            feats = M.config_features(key, backend=backend, fuse=fuse,
                                      tap_opt=tap_opt)
            t = model.predict(backend, fuse, feats["hbm_bytes"],
                              feats["launches"])
            row = (t, backend, fuse, tap_opt, None, "model")
        else:
            continue
        if best is None or row[:3] < best[:3]:
            best = row

    if best is None:
        RESOLUTIONS.inc(source="heuristic")
        choice = _heuristic(key)
    else:
        t, backend, fuse, tap_opt, block, source = best
        RESOLUTIONS.inc(source=source)
        if block_target is not None:
            block = None
        if block is None:
            block = AT.lookup(key.scheme, key.shape[-2:], fuse, backend,
                              key.device)
        choice = AutoChoice(backend=backend, fuse=fuse, tap_opt=tap_opt,
                            block=block, source=source, predicted_s=t)
    CHOICES.inc(backend=choice.backend, fuse=choice.fuse)
    return choice
