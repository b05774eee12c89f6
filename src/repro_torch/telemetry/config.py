"""Telemetry mode resolution: ``$REPRO_TORCH_TELEMETRY`` -> hot-path flags.

The whole subsystem is gated on one environment variable so the
overhead on the hot path is a branch:

* ``off``      — every instrument site is a no-op: counters drop their
  increments, :func:`repro_torch.telemetry.span` returns a shared no-op
  context manager, nothing allocates;
* ``counters`` (default) — metrics record, spans record nothing (no
  CUDA event, no ring record, nothing synchronises);
* ``spans``    — metrics *and* timed spans record (spans imply
  counters: a span without its surrounding counters is unreadable).

In every mode but ``off``, a span opened while a ``torch.profiler``
session records is also a range of its name in the profiler's trace,
next to the kernels it launches and on its clock
(:mod:`repro_torch.telemetry.spans`); no switch turns that on.

The variable carries the port's prefix so that a process holding both
this package and the reference package switches each plane on its own.
The environment is read once at import; tests (or embedders) flip modes
with :func:`set_mode` / :func:`reload` — re-reading the environment per
counter increment would itself be hot-path overhead.
"""
from __future__ import annotations

import os

MODE_ENV = "REPRO_TORCH_TELEMETRY"
MODES = ("off", "counters", "spans")
DEFAULT_MODE = "counters"


class _Config:
    """Resolved telemetry flags (module-global singleton ``CONFIG``).

    ``counters_on`` / ``spans_on`` are plain attribute reads so the
    instrument sites pay one branch, not a dict lookup or an env read.
    """

    __slots__ = ("mode", "counters_on", "spans_on")

    def __init__(self):
        self.mode = DEFAULT_MODE
        self.counters_on = True
        self.spans_on = False

    def apply(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(
                f"unknown telemetry mode {mode!r} (${MODE_ENV}); "
                f"available: {MODES}")
        self.mode = mode
        self.counters_on = mode != "off"
        self.spans_on = mode == "spans"


CONFIG = _Config()


def reload() -> str:
    """Re-read ``$REPRO_TORCH_TELEMETRY`` and apply it; returns the
    resolved mode."""
    CONFIG.apply(os.environ.get(MODE_ENV, DEFAULT_MODE) or DEFAULT_MODE)
    return CONFIG.mode


def set_mode(mode: str) -> str:
    """Explicitly set the telemetry mode for this process (tests, ops
    hooks); the env is left untouched so :func:`reload` restores it."""
    CONFIG.apply(mode)
    return CONFIG.mode


def mode() -> str:
    """The active telemetry mode ("off" | "counters" | "spans")."""
    return CONFIG.mode


reload()
