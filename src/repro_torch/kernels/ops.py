"""Single-level entry to the window kernel, and its cost model.

``apply_scheme_cuda`` runs one level of a named scheme — forward or
inverse — through the window kernel K1
(:func:`~repro_torch.kernels.polyphase.apply_steps_cuda`); multi-level
execution goes through the plan/executor engine
(:mod:`repro_torch.engine`), which shares the same memoized scheme-step
and program construction.  Inputs may be batched ``(..., H, W)``: the
batch rides the kernel's batch grid dimension.  On CPU tensors the
kernel's plain version runs.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch import compiler as C
from repro_torch.core import optimize as O
from repro_torch.core import schemes as S
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import tap_window as TW

__all__ = ["apply_scheme_cuda", "scheme_stats"]


def _kernel_fuse(fuse: str) -> str:
    """The engine's level-granularity modes ("scheme", "levels",
    "pyramid") all run one level as one launch."""
    if fuse not in ("none", "scheme", "levels", "pyramid"):
        raise ValueError(f"unknown fuse mode {fuse!r}")
    return "none" if fuse == "none" else "scheme"


@functools.lru_cache(maxsize=256)
def _windows(wavelet: str, scheme: str, optimize: bool, inverse: bool,
             fuse: str, tap_opt: str, compute_dtype: str, hp: int,
             wp: int) -> Tuple[TW.WindowProgram, ...]:
    """The level's programs encoded for the window kernel at the block
    the SMEM guard picks for ``(hp, wp)`` planes (as a plan holds them)."""
    programs = C.compile_scheme_programs(wavelet, scheme, optimize,
                                         inverse, tap_opt, fuse)
    block = TW.fit_block(programs, hp, wp)
    return tuple(TW.encode(p, block, compute_dtype) for p in programs)


def apply_scheme_cuda(x, *, wavelet: str = "cdf97",
                      scheme: str = "ns-polyconv", optimize: bool = False,
                      inverse: bool = False, fuse: str = "none",
                      compute_dtype: str = "float32",
                      tap_opt: str = "full"):
    """Single-level 2-D DWT step sequence through the window kernel.

    Forward: ``x`` is a (batch of) image(s) (..., H, W) -> returns the
    (LL, HL, LH, HH) planes, each (..., H/2, W/2).
    Inverse: ``x`` is the 4-tuple of planes -> returns the image(s).

    ``fuse="none"`` launches once per barrier step, any other mode once
    for the level.  ``tap_opt`` picks the tap-program compilation level
    ("off" runs the lowered raw walk, bit-identical to walking the
    matrices); ``compute_dtype`` the in-kernel arithmetic dtype.  The
    inverse ignores ``optimize``, as the engine does.
    """
    from repro_torch.engine.plan import scheme_steps  # deferred: cycle
    kfuse = _kernel_fuse(fuse)
    opt = bool(optimize) and not inverse
    if inverse:
        x = tuple(x)
        hp, wp = x[0].shape[-2:]
    else:
        hp, wp = x.shape[-2] // 2, x.shape[-1] // 2
    windows = _windows(wavelet, scheme, opt, bool(inverse), kfuse, tap_opt,
                       compute_dtype, int(hp), int(wp))
    return PP.apply_steps_cuda(scheme_steps(wavelet, scheme, opt, inverse),
                               x, windows=windows, image_out=bool(inverse))


def scheme_stats(wavelet: str, scheme: str, optimize: bool,
                 shape: Tuple[int, int], itemsize: int = 4,
                 fuse: str = "none", tap_opt: str = "full") -> dict:
    """Step count / op counts / modelled device-memory bytes of one level.

    ``fuse`` accepts the engine's level-granularity modes too: "scheme",
    "levels" and "pyramid" all collapse one level to one launch.  ``ops``
    is the paper-convention raw matrix count; ``ops_compiled`` (and
    ``macs_per_pixel``) come from the compiled tap program the kernel
    executes (absent under ``tap_opt="off"``, as in the reference).
    ``launches`` is the reference's ``pallas_calls``; ``hbm_bytes`` is
    the port's model of the window kernel
    (:func:`~repro_torch.kernels.polyphase.scheme_hbm_bytes`; K1 reads
    the image and writes it back itself, so no split or merge), at the
    block the SMEM guard picks.
    """
    sch = (O.build_optimized(wavelet, scheme) if optimize
           else S.build_scheme(wavelet, scheme))
    steps = PP.steps_of(sch)
    kfuse = _kernel_fuse(fuse)
    # the kernel runs the "off"-lowered program under tap_opt="off"
    programs = C.compile_scheme_programs(wavelet, scheme, optimize, False,
                                         tap_opt, kfuse)
    h, w = shape
    block = TW.fit_block(programs, h // 2, w // 2)
    out = {
        "wavelet": wavelet,
        "scheme": scheme + ("+opt" if optimize else ""),
        "fuse": fuse,
        "steps": len(steps),
        "launches": 1 if kfuse == "scheme" else len(steps),
        "ops": sch.num_ops,
        "hbm_bytes": PP.scheme_hbm_bytes(programs, shape, itemsize, block),
    }
    if tap_opt != "off":
        cst = C.program_stats(programs)
        out["ops_compiled"] = cst["macs"]
        out["macs_per_pixel"] = cst["macs_per_pixel"]
        out["halo_compiled"] = cst["halo"]
    return out
