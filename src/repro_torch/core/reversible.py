"""The integer path: one level of a reversible wavelet over int32 images.

ISO/IEC 15444-1 Annex F (JPEG 2000 lossless) codes a tile with the
reversible 5-3: integer lifting steps with floors, so int32 samples map
to int32 coefficients and back exactly.  A forward level (Annex F's
2D_SD) lifts every column (the vertical 1-D pass) and then every row of
the result (the horizontal pass); the inverse (2D_SR) undoes the rows,
then the columns.  Because the floors make each step non-linear, the
order is part of the transform: another order gives other subbands.

The edges take Annex F's whole-sample symmetric extension of the signal
(``x[-i] = x[i]``, ``x[N-1+i] = x[N-1-i]``, the tile at the origin, N
even).  On the polyphase components it comes to clamping the one
neighbour each step reads past an edge: the predict step reads
``s[M] = s[M-1]``, the update step ``d[-1] = d[0]``; the inverse's
predict reads the restored even samples the same way.

This is the ``"torch"`` backend's level and the plain version of the
reversible lifting kernel (:mod:`repro_torch.kernels.rev_lift`): plain
PyTorch on whole (batched) planes, ``>>`` as the floor of a division by
a power of two (an arithmetic shift on signed integers).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.wavelets import REVERSIBLE, ReversibleWavelet

#: the one sample dtype of the integer path
DTYPE = torch.int32

Subbands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def get_reversible(name: str) -> ReversibleWavelet:
    try:
        return REVERSIBLE[name]
    except KeyError:
        raise KeyError(f"unknown reversible wavelet {name!r}; available: "
                       f"{sorted(REVERSIBLE)}") from None


def _next(s: torch.Tensor) -> torch.Tensor:
    """``s[n+1]`` along the last axis, ``s[M]`` read as ``s[M-1]``."""
    return torch.cat([s[..., 1:], s[..., -1:]], dim=-1)


def _prev(d: torch.Tensor) -> torch.Tensor:
    """``d[n-1]`` along the last axis, ``d[-1]`` read as ``d[0]``."""
    return torch.cat([d[..., :1], d[..., :-1]], dim=-1)


def lift(x: torch.Tensor, dim: int, w: ReversibleWavelet
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward 1-D level of ``x`` along ``dim``: ``(low, high)``."""
    x = x.movedim(dim, -1)
    s, d = x[..., 0::2], x[..., 1::2]
    d = d - ((s + _next(s)) >> w.predict_shift)
    s = s + ((_prev(d) + d + w.update_round) >> w.update_shift)
    return s.movedim(-1, dim), d.movedim(-1, dim)


def unlift(s: torch.Tensor, d: torch.Tensor, dim: int,
           w: ReversibleWavelet) -> torch.Tensor:
    """Inverse of :func:`lift`: the interleaved signal along ``dim``."""
    s, d = s.movedim(dim, -1), d.movedim(dim, -1)
    s = s - ((_prev(d) + d + w.update_round) >> w.update_shift)
    d = d + ((s + _next(s)) >> w.predict_shift)
    x = torch.stack([s, d], dim=-1).reshape(*s.shape[:-1], -1)
    return x.movedim(-1, dim)


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype != DTYPE:
        raise TypeError(f"the reversible path transforms {DTYPE} samples, "
                        f"got {what} of {t.dtype}")
    if t.dim() < 2:
        raise ValueError(f"{what} must be (..., H, W), got {tuple(t.shape)}")


def level_forward(x: torch.Tensor, wavelet: str) -> Subbands:
    """One forward level of int32 images ``(..., H, W)`` (H and W even):
    ``(LL, HL, LH, HH)``, each ``(..., H/2, W/2)`` and contiguous, HL
    high horizontally."""
    _check(x, "input")
    w = get_reversible(wavelet)
    lo, hi = lift(x, -2, w)
    ll, hl = lift(lo, -1, w)
    lh, hh = lift(hi, -1, w)
    return tuple(t.contiguous() for t in (ll, hl, lh, hh))


def level_inverse(planes: Subbands, wavelet: str) -> torch.Tensor:
    """Inverse of :func:`level_forward`: ``(LL, HL, LH, HH)`` -> the
    int32 images ``(..., H, W)``."""
    for t, band in zip(planes, ("LL", "HL", "LH", "HH")):
        _check(t, band)
    w = get_reversible(wavelet)
    ll, hl, lh, hh = planes
    lo = unlift(ll, hl, -1, w)
    hi = unlift(lh, hh, -1, w)
    return unlift(lo, hi, -2, w).contiguous()
