"""Tap-program compiler: StepSpec sequences -> optimized flat tap programs.

A step sequence is compiled once, at plan-build time, into a
:class:`~repro_torch.compiler.ir.TapProgram` — a flat list of shift /
scale / accumulate / 1-D-filter ops — and optimization passes run over it:

* symbolic matrix **folding** of adjacent halo-0 and main matrices
  (:mod:`repro_torch.compiler.lower`, cost-guarded, via
  ``repro_torch.core.poly``);
* **rank-1 factorization** of separable-product entries into two 1-D
  passes, plus **CSE** of the shared normalized factors and repeated
  shifted terms across the four output planes
  (:mod:`repro_torch.compiler.passes`);
* **dead-term / unit-coefficient** strength reduction (pruning here,
  exact unit handling in the executors).

Opt levels: ``"off"`` lowers only (the raw walk, term for term),
``"exact"`` applies only bit-preserving cleanups, ``"full"`` (default)
applies everything.  ``"off"``/``"exact"`` programs execute bit-identically
to the raw matrix walk with flat term-by-term accumulation (the window
kernel's semantics; the torch ``apply_matrix`` walk sums per entry and so
matches only to ulp-level rounding), which is why the kernel backend runs
the ``"off"``-lowered program under ``tap_opt="off"`` and needs no second,
raw-matrix path.  ``"full"`` reassociates fp sums (parity is tested to
fp32 tolerances) and is what cuts MACs/pixel.

The programs, node for node, are those of the reference package's
compiler: the same passes over the same algebra.  Executors live in
:mod:`repro_torch.compiler.execute`; op counts come from
:meth:`TapProgram.stats`; the fused-pyramid margin schedules live in
:mod:`repro_torch.compiler.pyramid`.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

from repro_torch.compiler import execute, ir, lower, passes, pyramid
from repro_torch.compiler.ir import Node, TapProgram, Term
from repro_torch.compiler.passes import OPT_LEVELS, optimize_program
from repro_torch.compiler.pyramid import (PyramidSchedule,
                                          compile_pyramid_programs,
                                          forward_schedule, inverse_schedule,
                                          level_reaches)
from repro_torch.kernels.polyphase import scheme_steps

__all__ = [
    "Node", "TapProgram", "Term", "OPT_LEVELS", "compile_steps",
    "compile_scheme_programs", "optimize_program", "program_stats",
    "PyramidSchedule", "compile_pyramid_programs", "forward_schedule",
    "inverse_schedule", "level_reaches",
    "execute", "ir", "lower", "passes", "pyramid",
]


def compile_steps(steps: Sequence, opt: str = "full") -> TapProgram:
    """Compile one fused kernel group of StepSpecs into a program."""
    if opt not in OPT_LEVELS:
        raise ValueError(f"unknown opt level {opt!r}; available: "
                         f"{OPT_LEVELS}")
    prog = lower.lower_steps(steps, fold=(opt == "full"))
    return optimize_program(prog, opt)


@functools.lru_cache(maxsize=1024)
def compile_scheme_programs(wavelet: str, scheme: str, optimize: bool,
                            inverse: bool, opt: str, fuse: str
                            ) -> Tuple[TapProgram, ...]:
    """Compile a named scheme's programs, memoized process-wide.

    ``fuse="none"`` yields one program per barrier step; any other fuse
    mode yields a single whole-chain program (one kernel launch).  Each
    compilation (a cache miss) is counted in ``repro_tap_compiles_total``
    and runs inside a ``compile.scheme`` span.
    """
    from repro_torch import telemetry as T
    T.counter("repro_tap_compiles_total",
              "tap-program compilations (lru_cache misses of "
              "compile_scheme_programs)",
              labelnames=("scheme", "opt")).inc(scheme=scheme, opt=opt)
    with T.span("compile.scheme", scheme=scheme, opt=opt, fuse=fuse,
                inverse=inverse):
        steps = scheme_steps(wavelet, scheme, optimize, inverse)
        if fuse == "none":
            return tuple(compile_steps((st,), opt) for st in steps)
        return (compile_steps(steps, opt),)


def program_stats(programs: Sequence[TapProgram]) -> dict:
    """Aggregate cost of a program sequence (one transform level)."""
    agg = {"nodes": 0, "terms": 0, "macs": 0, "muls": 0, "adds": 0}
    halo = 0
    for p in programs:
        st = p.stats()
        for k in agg:
            agg[k] += st[k]
        halo = max(halo, st["halo"])
    agg["halo"] = halo
    agg["macs_per_pixel"] = agg["macs"] / 4.0
    return agg
