"""Traffic drivers, one module per kind of traffic, found by name.

A traffic file ``portbench/traffic/<traffic>.json`` holds only data: the
name of its ``driver``, the parameters that driver reads, and
``trace_seconds``, the length of a ``--trace 1`` run's traced
sub-window.  ``portbench/drivers/<driver>.py`` gives:

``prepare(program, config, traffic, device) -> Prepared``
    the program's plan for the cell, built and its kernels loaded;
``inputs(data, traffic) -> list``
    the request inputs, cut from the data array the seed made;
``warm(entry, inputs, traffic)``
    every shape the window will use, once;
``request(entry, x)``
    one request, enqueued and not waited on (set-up counts its
    synchronising calls);
``control(reference, config, traffic, device)``
    entry points of the same form that compute with the reference in
    the precision below the configuration's: the check's control;
``run(entry, inputs, traffic, seconds, seed, device_type, tracer)``
    the measured window: a :class:`portbench.window.Window`;
``compare(reference, config, traffic, x, kept) -> dict``
    the check's numbers for one kept request, whose input was ``x``.

``reference`` is the module :func:`portbench.reference.load` finds for
the configuration's wavelet.  A new kind of traffic is a new file here
and a new data file under ``portbench/traffic/``; no file that is there
changes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Tuple


@dataclasses.dataclass
class Prepared:
    """A driver's set-up: the entry points the window drives, the shape
    of one request's input, a line that says what the plan resolved to,
    and how many ways the plan departs from the configuration (a
    fallback taken, a fused path not built)."""

    entry: Any
    request_shape: Tuple[int, ...]
    describe: str
    degraded: int


def load(name: str):
    """The driver module ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")
