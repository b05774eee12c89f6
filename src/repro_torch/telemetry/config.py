"""Telemetry mode resolution: ``$REPRO_TORCH_TELEMETRY`` -> hot-path flags.

The whole subsystem is gated on one environment variable so the
overhead on the hot path is a branch:

* ``off``      — every instrument site is a no-op: counters drop their
  increments, :func:`repro_torch.telemetry.span` returns a shared no-op
  context manager, nothing allocates;
* ``counters`` (default) — metrics record, spans are no-ops (no CUDA
  event is recorded and nothing synchronises);
* ``spans``    — metrics *and* timed spans record (spans imply
  counters: a span without its surrounding counters is unreadable).

``$REPRO_TORCH_TELEMETRY_PROFILER=1`` additionally mirrors every span
into a ``torch.profiler.record_function`` range, so the spans land in
``torch.profiler`` traces next to the kernels they wrap.

The variables carry the port's prefix so that a process holding both
this package and the reference package switches each plane on its own.
The environment is read once at import; tests (or embedders) flip modes
with :func:`set_mode` / :func:`reload` — re-reading the environment per
counter increment would itself be hot-path overhead.
"""
from __future__ import annotations

import os

MODE_ENV = "REPRO_TORCH_TELEMETRY"
PROFILER_ANNOTATIONS_ENV = "REPRO_TORCH_TELEMETRY_PROFILER"
MODES = ("off", "counters", "spans")
DEFAULT_MODE = "counters"


class _Config:
    """Resolved telemetry flags (module-global singleton ``CONFIG``).

    ``counters_on`` / ``spans_on`` are plain attribute reads so the
    instrument sites pay one branch, not a dict lookup or an env read.
    """

    __slots__ = ("mode", "counters_on", "spans_on", "profiler_annotations")

    def __init__(self):
        self.mode = DEFAULT_MODE
        self.counters_on = True
        self.spans_on = False
        self.profiler_annotations = False

    def apply(self, mode: str, profiler_annotations: bool) -> None:
        if mode not in MODES:
            raise ValueError(
                f"unknown telemetry mode {mode!r} (${MODE_ENV}); "
                f"available: {MODES}")
        self.mode = mode
        self.counters_on = mode != "off"
        self.spans_on = mode == "spans"
        self.profiler_annotations = bool(profiler_annotations)


CONFIG = _Config()


def reload() -> str:
    """Re-read ``$REPRO_TORCH_TELEMETRY`` /
    ``$REPRO_TORCH_TELEMETRY_PROFILER`` and apply them; returns the
    resolved mode."""
    CONFIG.apply(os.environ.get(MODE_ENV, DEFAULT_MODE) or DEFAULT_MODE,
                 os.environ.get(PROFILER_ANNOTATIONS_ENV, "") not in
                 ("", "0", "false", "False"))
    return CONFIG.mode


def set_mode(mode: str) -> str:
    """Explicitly set the telemetry mode for this process (tests, ops
    hooks); the env is left untouched so :func:`reload` restores it."""
    CONFIG.apply(mode, CONFIG.profiler_annotations)
    return CONFIG.mode


def mode() -> str:
    """The active telemetry mode ("off" | "counters" | "spans")."""
    return CONFIG.mode


reload()
