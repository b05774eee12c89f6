"""Resilient executor dispatch: retry, then degrade down the chain.

The paper's central property — the same DWT computed by interchangeable
schemes/backends with matching results — is what a production system
exploits when a path *fails*, not just when it is slow.  :func:`dispatch`
wraps every plan execution
(:meth:`repro_torch.engine.plan.DwtPlan.execute` routes here), as the
reference package's does:

1. **retry** the plan's own executor (bounded, backed-off) — transient
   failures recover in place;
2. **degrade** down a capability-checked chain
   (``fuse: pyramid → levels → none``, then
   ``backend: cuda → conv → torch``; a reversible wavelet's plan goes
   straight to the plain integer path, ``torch``, and is held to
   equality), re-resolving the plan through the
   LRU cache and **verifying** the fallback output against the
   ``torch/none`` reference (the exactness contract) before accepting it;
3. record every hop in ``repro_fallbacks_total{from, to, site}``.

What the chain runs past depends on where the plan runs.  On the card,
and on the ``cuda`` backend anywhere, only the fault plane's own errors
degrade: an injected fault (:class:`~repro_torch.faults.inject.InjectedFault`)
and the corruption the armed finite-ness sweep finds
(:class:`ExactnessError`).  Every other error there — a kernel that fails
to build, load or launch, a wrapper's shape or shared-memory check, an
out-of-memory error, a CUDA error — propagates unchanged, neither retried
nor degraded, so a failing kernel is never hidden behind a plain
version.  (A CUDA error from a kernel is also sticky: it may surface at a
later synchronisation rather than inside the attempt, and it leaves the
context unusable, so no hop on the same device could run anyway.)  A
plan of the ``torch`` or ``conv`` backend on the CPU degrades on any
host-side failure, as the reference package's plans do.

Config via env (read once; :func:`reload` re-reads):

* ``REPRO_TORCH_RESILIENCE=on|off`` — ``off`` restores fail-fast (the
  first failure propagates); default on;
* ``REPRO_TORCH_RESILIENCE_RETRIES`` — in-place retries before degrading
  (default 1);
* ``REPRO_TORCH_RESILIENCE_VERIFY=on|off`` — verify fallback outputs
  against the reference (default on; the reference itself is never
  re-verified).

Overhead when nothing fails: one ``try`` frame per execution and no
device synchronisation — the finite-ness sweep that detects corruption
runs only while the fault plane is armed (it is the only
synchronisation the plane adds).

Import discipline: this module imports telemetry and the fault plane
at import time and pulls the engine in lazily, so ``engine/plan.py``
can import it at module top without a cycle.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import torch

from repro_torch import telemetry as T
from repro_torch.core.wavelets import is_reversible
from repro_torch.faults import inject
from repro_torch.faults.policy import DeadlineExceeded, retry_call

#: counted in every telemetry mode: a hop must never go unseen
FALLBACKS = T.counter(
    "repro_fallbacks_total",
    "Degradation-chain hops taken after executor failure",
    labelnames=("from", "to", "site"), gated=False)

ENABLE_ENV = "REPRO_TORCH_RESILIENCE"
RETRIES_ENV = "REPRO_TORCH_RESILIENCE_RETRIES"
VERIFY_ENV = "REPRO_TORCH_RESILIENCE_VERIFY"

#: degradation orders (left = most capable); "scheme" degrades to "none"
BACKEND_CHAIN = ("cuda", "conv", "torch")
FUSE_DEMOTIONS = {"pyramid": ("levels", "none"), "scheme": ("none",),
                  "levels": ("none",), "none": ()}


@dataclasses.dataclass
class ResilienceConfig:
    enabled: bool = True
    retries: int = 1
    backoff_s: float = 0.005
    verify: bool = True


def _from_env() -> ResilienceConfig:
    return ResilienceConfig(
        enabled=os.environ.get(ENABLE_ENV, "on").lower() != "off",
        retries=int(os.environ.get(RETRIES_ENV, "1") or 1),
        verify=os.environ.get(VERIFY_ENV, "on").lower() != "off")


CONFIG = _from_env()


def reload() -> ResilienceConfig:
    """Re-read the ``REPRO_TORCH_RESILIENCE*`` env vars into
    :data:`CONFIG`."""
    global CONFIG
    CONFIG = _from_env()
    return CONFIG


class ExactnessError(RuntimeError):
    """A fallback result disagreed with the torch reference beyond the
    exactness contract's tolerance — the hop is rejected, the chain
    continues."""


class DegradationExhausted(RuntimeError):
    """Every candidate in the degradation chain failed; carries the
    original executor failure as ``__cause__``."""


def degradation_chain(key) -> List:
    """Capability-checked fallback PlanKeys for ``key``, most-capable
    first: same-backend fuse demotions, then lower backends (each at
    the highest fuse it supports).

    >>> from repro_torch.engine.plan import PlanKey
    >>> k = PlanKey("cdf97", "ns-polyconv", 2, (64, 64), "float32",
    ...             "cuda", False, "pyramid", "periodic", device="cpu")
    >>> [(c.backend, c.fuse) for c in degradation_chain(k)]
    [('cuda', 'levels'), ('cuda', 'none'), ('conv', 'levels'), ('torch', 'levels')]
    """
    from repro_torch.engine import backends as B
    out, seen = [], {(key.backend, key.fuse)}

    def admit(cand) -> None:
        tag = (cand.backend, cand.fuse)
        if tag in seen:
            return
        try:
            B.get_backend(cand.backend).validate(cand)
        except Exception:
            return
        seen.add(tag)
        out.append(cand)

    # a reversible plan runs one kernel launch a level at every fuse
    # mode: its one hop is the plain integer path (backend "torch")
    demotions = () if is_reversible(key.wavelet) \
        else FUSE_DEMOTIONS.get(key.fuse, ("none",))
    for f in demotions:
        admit(dataclasses.replace(key, fuse=f))
    start = (BACKEND_CHAIN.index(key.backend) + 1
             if key.backend in BACKEND_CHAIN else 0)
    # backend hops also demote fuse: the failing mode is not retried on
    # the weaker backend, only its demotions (or "none" when already
    # there) — the chain's tail is always the torch reference path
    for b in BACKEND_CHAIN[start:]:
        n = len(out)
        for f in demotions or ("none",):
            admit(dataclasses.replace(key, backend=b, fuse=f))
            if len(out) > n:    # highest supported fuse on b is enough
                break
    return out


def _tolerance(key) -> Tuple[float, float]:
    """The exactness contract across chain hops: same transform, other
    path.  Float32 paths agree to fp-accumulation order; bf16 compute
    is inherently coarser; integer (reversible) paths agree exactly, so
    the reversible lifting kernel's hop to the plain integer path is
    held to equality."""
    if key.compute_dtype == "int32":
        return 0.0, 0.0
    if key.compute_dtype == "bfloat16":
        return 2e-2, 2e-2
    return 1e-3, 1e-4


def _leaves(result) -> List:
    if isinstance(result, (tuple, list)):
        out = []
        for r in result:
            out.extend(_leaves(r))
        return out
    return [result]


def _has_nonfinite(result) -> bool:
    """Any NaN/Inf in the result — one device synchronisation per call;
    run only while the fault plane is armed."""
    return any(not bool(torch.isfinite(leaf).all())
               for leaf in _leaves(result))


def _verify(result, reference, key) -> None:
    got, want = _leaves(result), _leaves(reference)
    rtol, atol = _tolerance(key)
    if len(got) != len(want):
        raise ExactnessError(
            f"fallback produced {len(got)} planes, reference {len(want)}")
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.allclose(
                g.double(), w.double(), rtol=rtol, atol=atol,
                equal_nan=False):
            raise ExactnessError(
                f"fallback output disagrees with the torch reference "
                f"beyond the exactness contract (rtol={rtol}, "
                f"atol={atol}) for {key.scheme} on {key.backend}")


def _reference_key(key):
    return dataclasses.replace(key, backend="torch", fuse="none")


def _run_key(cand, op: str, args):
    """Build (via the LRU cache) and run one candidate plan, raw —
    bypassing plan.execute so a fallback never recursively dispatches
    into its own recovery."""
    from repro_torch.engine import cache as EC
    plan = EC.global_cache().get(cand)
    fn = plan._forward if op == "forward" else plan._inverse
    return fn(*args)


def _strict(key) -> bool:
    """Does ``key``'s plan run a kernel of the card?  Then only the fault
    plane's own errors may degrade it (see the module docstring)."""
    return key.backend == "cuda" or key.device.startswith("cuda")


#: the errors a strict plan retries and degrades on
PLANE_ERRORS = (inject.InjectedFault, ExactnessError)


def _recoverable(key, err: Exception) -> bool:
    return isinstance(err, PLANE_ERRORS) or not _strict(key)


def dispatch(plan, op: str, args) -> object:
    """Run ``plan``'s ``op`` executor with retry + degradation.

    ``op`` is ``"forward"`` (args = ``(x,)``) or ``"inverse"``
    (args = ``(ll, details)`` or ``(leaves,)``).  Raises the *original*
    executor failure (as ``DegradationExhausted.__cause__``) when every
    chain hop fails, and an error the chain may not run past (see the
    module docstring) as it is.
    """
    site = f"execute.{op}"
    fn = plan._forward if op == "forward" else plan._inverse

    def attempt():
        inject.maybe_inject(site, backend=plan.key.backend,
                            fuse=plan.key.fuse)
        out = fn(*args)
        if inject.active() is not None:
            out = inject.corrupt_output(site, out)
            # silent-corruption detection is only armed while the fault
            # plane is active: the finite-ness sweep synchronises with
            # the device, which production must not pay
            if _has_nonfinite(out):
                raise ExactnessError(
                    f"non-finite values in {site} output "
                    f"(backend={plan.key.backend}, fuse={plan.key.fuse})")
        return out

    cfg = CONFIG
    if not cfg.enabled:
        return attempt()
    try:
        return retry_call(attempt, site=site, retries=cfg.retries,
                          backoff_s=cfg.backoff_s,
                          retry_on=(PLANE_ERRORS if _strict(plan.key)
                                    else (Exception,)))
    except DeadlineExceeded:
        raise
    except Exception as err:
        if not _recoverable(plan.key, err):
            raise
        return _degrade(plan, op, args, err)


def _degrade(plan, op: str, args, err: Exception):
    key = plan.key
    site = getattr(err, "site", f"execute.{op}")
    src = f"{key.backend}/{key.fuse}"
    last = err
    for cand in degradation_chain(key):
        try:
            out = _run_key(cand, op, args)
            if CONFIG.verify and not (cand.backend == "torch"
                                      and cand.fuse == "none"):
                ref = _run_key(_reference_key(key), op, args)
                _verify(out, ref, key)
            FALLBACKS.inc(**{"from": src, "to":
                             f"{cand.backend}/{cand.fuse}", "site": site})
            return out
        except Exception as e:          # try the next, weaker hop
            if not _recoverable(key, e):
                raise
            last = e
    raise DegradationExhausted(
        f"all degradation candidates failed for {src} after {site} "
        f"failure (last: {type(last).__name__}: {last})") from err


def stats() -> dict:
    """The resilience slice of ``engine.stats()['faults']``."""
    fb = sum(row["value"] for row in FALLBACKS.series())
    from repro_torch.faults.policy import RETRIES
    rt = sum(row["value"] for row in RETRIES.series())
    return {"enabled": CONFIG.enabled, "fallbacks": int(fb),
            "retries": int(rt)}
