"""Recovery policies: retry/backoff, deadlines, circuit breakers.

Small, stdlib-only building blocks (the reference package's) shared by
the executor dispatch (:mod:`repro_torch.faults.degrade`) and, once
those slices are ported, the streaming pipeline and the serve
scheduler:

* :func:`retry_call` — bounded retries with exponential backoff and an
  optional wall-clock :class:`Deadline`;
* :class:`Deadline` — an absolute time budget threaded through nested
  calls (``remaining()`` shrinks, never resets);
* :class:`CircuitBreaker` — the classic closed → open → half-open
  state machine, used per serve bucket-config so a poisoned plan
  config fails fast instead of burning worker time.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type

from repro_torch import telemetry as T

RETRIES = T.counter(
    "repro_retries_total",
    "Recovery retries attempted, by site",
    labelnames=("site",))

BREAKER_TRANSITIONS = T.counter(
    "repro_circuit_transitions_total",
    "Circuit-breaker state transitions, by new state",
    labelnames=("state",))


class DeadlineExceeded(TimeoutError):
    """A request/operation ran past its wall-clock budget."""


class Deadline:
    """An absolute wall-clock budget.

    >>> d = Deadline(10.0)
    >>> d.remaining() <= 10.0
    True
    """

    def __init__(self, budget_s: float, *, clock=time.monotonic):
        self._clock = clock
        self.t_end = clock() + float(budget_s)

    def remaining(self) -> float:
        return self.t_end - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded its deadline")


def retry_call(fn: Callable, *, site: str, retries: int = 2,
               backoff_s: float = 0.005, backoff_mult: float = 2.0,
               deadline: Optional[Deadline] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,)):
    """Call ``fn()`` with up to ``retries`` recovery attempts.

    Backoff doubles per attempt (capped by the deadline's remaining
    budget); the *last* exception is re-raised when the budget is
    exhausted, so callers see the organic failure, not a wrapper.
    ``DeadlineExceeded`` is never swallowed — a blown deadline must
    propagate immediately rather than be retried into a longer stall.
    """
    attempt = 0
    while True:
        try:
            if deadline is not None:
                deadline.check(site)
            return fn()
        except DeadlineExceeded:
            raise
        except retry_on:
            if attempt >= retries:
                raise
            attempt += 1
            RETRIES.inc(site=site)
            pause = backoff_s * (backoff_mult ** (attempt - 1))
            if deadline is not None:
                pause = min(pause, max(0.0, deadline.remaining()))
            if pause > 0:
                time.sleep(pause)


class CircuitOpenError(RuntimeError):
    """Fast-fail: the breaker for this key is open."""


class CircuitBreaker:
    """Closed → open → half-open breaker.

    * **closed**: calls flow; ``failure_threshold`` *consecutive*
      failures trip it open (one success resets the streak);
    * **open**: :meth:`allow` refuses for ``cooldown_s``;
    * **half-open**: after cooldown, exactly one probe call is let
      through — success closes the breaker, failure re-opens it (and
      restarts the cooldown).

    Thread-safe; pure state machine with an injectable clock so tests
    don't sleep.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0,
                 *, clock=time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0           # consecutive, while closed
        self._opened_at = 0.0
        self._probing = False        # a half-open probe is in flight

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek()

    def _peek(self) -> str:
        if self._state == "open" and \
                self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return self._state

    def _transition(self, state: str) -> None:
        self._state = state
        BREAKER_TRANSITIONS.inc(state=state)

    def allow(self) -> bool:
        """May a call proceed right now?  (Claims the probe slot when
        half-open — call :meth:`record` with the probe's outcome.)"""
        with self._lock:
            s = self._peek()
            if s == "closed":
                return True
            if s == "half-open" and not self._probing:
                self._probing = True
                return True
            return False

    def record(self, ok: bool) -> None:
        """Report the outcome of an allowed call."""
        with self._lock:
            probing = self._probing
            self._probing = False
            if ok:
                if self._state != "closed":
                    self._transition("closed")
                self._failures = 0
                return
            if self._state == "open" and probing:
                # failed half-open probe: re-open, restart cooldown
                self._opened_at = self._clock()
                BREAKER_TRANSITIONS.inc(state="open")
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._failures = 0
                self._transition("open")
