"""``repro_torch.faults`` — deterministic fault injection + resilience
policies, the reference package's plane in PyTorch.

Three layers:

* **plan** (:mod:`repro_torch.faults.plan`) — the seeded
  :class:`FaultPlan` parsed from ``$REPRO_TORCH_FAULTS`` / a scenario
  file: which sites fail, how (raise / hang / slow / corrupt), and when
  (prob / once / always);
* **inject** (:mod:`repro_torch.faults.inject`) — the hooks the stack's
  seams call (:func:`maybe_inject`, :func:`corrupt_output`); one-branch
  no-ops when no plan is active;
* **policies** (:mod:`repro_torch.faults.policy`,
  :mod:`repro_torch.faults.degrade`) — retry/backoff/deadline, circuit
  breaker, and the capability-checked backend degradation chain
  wrapping every plan execution.

    REPRO_TORCH_FAULTS="pyramid.launch=always" python app.py
    # -> pyramid launches fail; execution degrades cuda/pyramid ->
    #    cuda/levels, verified against the torch reference, counted in
    #    repro_fallbacks_total{from,to,site}
"""
from repro_torch.faults.plan import (FAULTS_ENV, KINDS, SEED_ENV, SITES,
                                     FaultPlan, FaultSpec, load_scenario,
                                     parse_faults)
from repro_torch.faults.inject import (INJECTIONS, InjectedFault, activate,
                                       active, corrupt_output, maybe_inject,
                                       reload)
from repro_torch.faults.policy import (CircuitBreaker, CircuitOpenError,
                                       Deadline, DeadlineExceeded,
                                       retry_call)
from repro_torch.faults.degrade import (CONFIG, DegradationExhausted,
                                        ExactnessError, ResilienceConfig,
                                        degradation_chain, dispatch)
from repro_torch.faults import inject as _inject

__all__ = [
    "FaultPlan", "FaultSpec", "SITES", "KINDS", "FAULTS_ENV", "SEED_ENV",
    "parse_faults", "load_scenario",
    "InjectedFault", "maybe_inject", "corrupt_output", "activate",
    "active", "reload", "INJECTIONS",
    "Deadline", "DeadlineExceeded", "retry_call", "CircuitBreaker",
    "CircuitOpenError",
    "ResilienceConfig", "CONFIG", "degradation_chain", "dispatch",
    "ExactnessError", "DegradationExhausted",
    "stats",
]

# arm the plane from the environment once, at first import; reload()
# re-reads after an env change
_inject.reload()


def stats() -> dict:
    """The ``engine.stats()["faults"]`` section: plan + policy state."""
    from repro_torch.faults import degrade as _degrade
    out = _inject.stats()
    out.update(_degrade.stats())
    return out
