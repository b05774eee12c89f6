"""Injection hooks: the seams call here; the plan decides.

Two hook shapes cover every site:

* :func:`maybe_inject` — placed where a site *does* something: may
  raise :class:`InjectedFault`, sleep (slow), or sleep-then-raise
  (hang, modelling a stall the caller's deadline must cut short);
* :func:`corrupt_output` — placed where a site *returns* something:
  NaN-poisons the value so downstream exactness checks must catch it.

Both are one-branch no-ops when no
:class:`~repro_torch.faults.plan.FaultPlan` is active (``_ACTIVE is
None``), which is the production default.

The active plan comes from ``$REPRO_TORCH_FAULTS`` (read once, at first
import of :mod:`repro_torch.faults`) or :func:`activate` (tests, chaos
runs).  Every fired fault is counted in
``repro_fault_injections_total{site, kind}`` so a chaos run can assert
its schedule actually executed.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch

from repro_torch import telemetry as T
from repro_torch.faults.plan import (FAULTS_ENV, SEED_ENV, FaultPlan,
                                     FaultSpec)

INJECTIONS = T.counter(
    "repro_fault_injections_total",
    "Injected faults fired, by site and kind",
    labelnames=("site", "kind"))

#: kinds expressible at a call-site hook (corrupt needs a value hook)
CALL_KINDS: Tuple[str, ...] = ("raise", "hang", "slow")

_ACTIVE: Optional[FaultPlan] = None


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised in production).

    Recovery policies treat it exactly like the organic failure it
    models; tests and chaos runs match on the type to tell injected
    faults from real bugs.
    """

    def __init__(self, site: str, kind: str):
        super().__init__(f"injected {kind} fault at site {site!r}")
        self.site = site
        self.kind = kind


def activate(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the active fault plan (None deactivates).

    Returns the previous plan so tests can restore it.
    """
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    return prev


def active() -> Optional[FaultPlan]:
    """The currently active plan, or None (faults plane off)."""
    return _ACTIVE


def reload() -> Optional[FaultPlan]:
    """(Re-)read ``$REPRO_TORCH_FAULTS`` / ``$REPRO_TORCH_FAULTS_SEED``,
    install and return the resulting plan (None when unset).  Called once
    at package import; callable again after an env change."""
    text = os.environ.get(FAULTS_ENV, "").strip()
    seed = int(os.environ.get(SEED_ENV, "0") or 0)
    plan = FaultPlan.from_text(text, seed=seed) if text else None
    activate(plan)
    return plan


def maybe_inject(site: str, **ctx) -> None:
    """Fire the site's armed raise/hang/slow fault, if any.

    Placed *inside* retry loops so a retried attempt redraws — a
    ``prob`` fault can then be recovered by retry, while ``always``
    exhausts the budget and exercises the degradation path.  ``ctx`` is
    advisory (backend, shape, ...).
    """
    if _ACTIVE is None:
        return
    spec = _ACTIVE.should_fire(site, CALL_KINDS)
    if spec is None:
        return
    _fire(spec, ctx)


def _fire(spec: FaultSpec, ctx: dict) -> None:
    INJECTIONS.inc(site=spec.site, kind=spec.kind)
    if spec.kind == "slow":
        time.sleep(spec.sleep_s)
        return
    if spec.kind == "hang":
        # A stall, not an error: sleep out the (long) delay, then raise
        # so a workload without deadlines still terminates.  Real
        # recovery must come from the caller's deadline firing first.
        time.sleep(spec.sleep_s)
    raise InjectedFault(spec.site, spec.kind)


def corrupt_output(site: str, value):
    """Fire the site's armed ``corrupt`` fault against a result value.

    Returns ``value`` unchanged when nothing fires; otherwise a poisoned
    copy (:func:`_poison`) — the silent-corruption model the exactness
    verifier and ``validate="nan"`` guard must catch.
    """
    if _ACTIVE is None:
        return value
    spec = _ACTIVE.should_fire(site, ("corrupt",))
    if spec is None:
        return value
    INJECTIONS.inc(site=spec.site, kind=spec.kind)
    return _poison(value)


def _poison(value):
    """A NaN-filled copy of a tensor, or of every tensor of a nested
    tuple/list (non-float tensors are copied as they are; anything else
    becomes None).  Never writes into ``value``: the caller, a cached
    plan or a kernel may still hold it."""
    if isinstance(value, torch.Tensor):
        if value.is_floating_point() or value.is_complex():
            return torch.full_like(value, float("nan"))
        return value.clone()
    if isinstance(value, (tuple, list)):
        return type(value)(_poison(v) for v in value)
    return None


def stats() -> dict:
    """The ``engine.stats()["faults"]`` section: active plan + fires."""
    if _ACTIVE is None:
        return {"active": False, "injections": 0}
    fired = sum(_ACTIVE.fired.values())
    return {"active": True, "injections": fired, "plan": _ACTIVE.stats()}
