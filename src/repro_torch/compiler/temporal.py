"""1-D temporal lifting programs for the 3-D (t+2D) DWT.

The 3-D transform factors each level into a 1-D lifting pass along the
temporal axis (``dim=-3``) followed by the compiled 2-D transform of
both temporal half-bands (frames ride the free leading batch dims every
2-D backend already accepts).  This module compiles a wavelet's
predict/update pairs (:mod:`repro_torch.core.wavelets`) into a flat
:class:`TemporalProgram` once per (wavelet, direction) and executes it
with periodic ``torch.roll`` arithmetic — the same cyclic-boundary
convention as the 2-D polyphase algebra, so ``boundary="periodic"``
means the same thing on every axis.

The functions here are the pass in plain PyTorch, as the reference runs
it as ``jnp`` between its Pallas kernels: what the ``"torch"`` and
``"conv"`` backends run, and the plain version of the ``"cuda"``
backend's temporal lifting kernel (:mod:`repro_torch.kernels.
temporal_lift`, one launch per level and direction), which equals them
bit for bit.  Each tap is rounded to the compute dtype before it
multiplies (:func:`~repro_torch.core.schemes.coef`), as the reference's
``jnp.asarray(c, compute_dtype)`` does.

The inverse applies the same taps negated, in reverse order, and undoes
the scaling first: the round trip is exact up to the rounding of each
accumulation (each tap is added on its own, so ``(d + a) + b`` is undone
as ``(d' - a) - b``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.compiler.execute import coef
from repro_torch.core import wavelets as W

__all__ = ["TemporalStep", "TemporalProgram", "compile_temporal",
           "temporal_split", "temporal_merge", "temporal_forward",
           "temporal_inverse", "TIME_AXIS"]

#: the temporal axis of a (..., T, H, W) volume
TIME_AXIS = -3


@dataclasses.dataclass(frozen=True)
class TemporalStep:
    """One lifting update ``target += sum_k c_k · other[n - k]``."""

    target: str                              # "d" (predict) | "s" (update)
    taps: Tuple[Tuple[int, float], ...]      # ((k, c_k), ...) sorted by k


@dataclasses.dataclass(frozen=True)
class TemporalProgram:
    """A compiled 1-D lifting chain along the temporal axis.

    Forward programs scale *after* the steps (``s *= zeta``,
    ``d *= 1/zeta``); inverse programs undo the scaling *before* their
    (reversed, negated) steps — the exact mirror.
    """

    wavelet: str
    inverse: bool
    steps: Tuple[TemporalStep, ...]
    s_scale: float
    d_scale: float

    @property
    def reach(self) -> int:
        """Max |tap offset| — the temporal halo of one level."""
        return max((abs(k) for st in self.steps for k, _ in st.taps),
                   default=0)


@functools.lru_cache(maxsize=64)
def compile_temporal(wavelet: str, inverse: bool = False) -> TemporalProgram:
    """Compile one wavelet's lifting pairs into a temporal program
    (memoized per process, like :func:`compile_scheme_programs`)."""
    wv = W.get_wavelet(wavelet)
    fwd = []
    for pair in wv.pairs:
        fwd.append(TemporalStep("d", tuple(sorted(pair.predict.items()))))
        fwd.append(TemporalStep("s", tuple(sorted(pair.update.items()))))
    if not inverse:
        return TemporalProgram(wavelet=wavelet, inverse=False,
                               steps=tuple(fwd), s_scale=wv.zeta,
                               d_scale=1.0 / wv.zeta)
    inv = tuple(TemporalStep(st.target, tuple((k, -c) for k, c in st.taps))
                for st in reversed(fwd))
    return TemporalProgram(wavelet=wavelet, inverse=True, steps=inv,
                           s_scale=1.0 / wv.zeta, d_scale=wv.zeta)


def temporal_split(x: torch.Tensor):
    """Polyphase split along time: (..., T, H, W) -> even/odd halves
    (strided views of ``x``)."""
    if x.shape[TIME_AXIS] % 2:
        raise ValueError(
            f"temporal axis must be even, got T={x.shape[TIME_AXIS]} "
            f"in shape {tuple(x.shape)}")
    return x[..., 0::2, :, :], x[..., 1::2, :, :]


def temporal_merge(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`temporal_split`: interleave the half-bands."""
    y = torch.stack([s, d], dim=-3)          # (..., T/2, 2, H, W)
    shape = s.shape[:-3] + (2 * s.shape[-3],) + s.shape[-2:]
    return y.reshape(shape)


def _run_steps(s, d, prog: TemporalProgram):
    cur = {"s": s, "d": d}
    for st in prog.steps:
        src = cur["s" if st.target == "d" else "d"]
        acc = cur[st.target]
        for k, c in st.taps:
            acc = acc + torch.roll(src, k, dims=TIME_AXIS) \
                * coef(c, src.dtype)
        cur[st.target] = acc
    return cur["s"], cur["d"]


def _scale(s, d, prog: TemporalProgram):
    if prog.s_scale != 1.0:
        s = s * coef(prog.s_scale, s.dtype)
        d = d * coef(prog.d_scale, d.dtype)
    return s, d


def temporal_forward(x: torch.Tensor, prog: TemporalProgram,
                     compute_dtype: torch.dtype = torch.float32):
    """One forward temporal level: (..., T, H, W) -> (low, high) with
    T/2 frames each.  Arithmetic runs in ``compute_dtype``; I/O stays
    in the input dtype (matching the 2-D level executors)."""
    out_dtype = x.dtype
    s, d = temporal_split(x)
    s, d = s.to(compute_dtype), d.to(compute_dtype)
    s, d = _scale(*_run_steps(s, d, prog), prog)
    return s.to(out_dtype), d.to(out_dtype)


def temporal_inverse(s: torch.Tensor, d: torch.Tensor,
                     prog: TemporalProgram,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """One inverse temporal level: (low, high) -> (..., T, H, W).
    ``prog`` must be the inverse program (``compile_temporal(w, True)``)."""
    out_dtype = s.dtype
    s, d = _scale(s.to(compute_dtype), d.to(compute_dtype), prog)
    s, d = _run_steps(s, d, prog)
    return temporal_merge(s, d).to(out_dtype)
