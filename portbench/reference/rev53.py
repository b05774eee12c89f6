"""The reversible 5-3 of ISO/IEC 15444-1 Annex F, plain PyTorch.

Written from the standard's procedures, in its own form: every 1-D
transform extends the signal by the periodic symmetric extension of
1D_EXTR (F.3.7 / F.4.7: whole-sample mirror, ``X(-i) = X(i)``,
``X(N-1+i) = X(N-1-i)``, period ``2 (N - 1)``), then filters the
interleaved signal.  The forward 1D_FILTR_5-3R (F.4.8.2), over a
signal ``X`` that starts at an even index:

    Y(2n+1) = X(2n+1) - floor((X(2n) + X(2n+2)) / 2)
    Y(2n)   = X(2n)   + floor((Y(2n-1) + Y(2n+1) + 2) / 4)

and the inverse (F.3.8.2):

    X(2n)   = Y(2n)   - floor((Y(2n-1) + Y(2n+1) + 2) / 4)
    X(2n+1) = Y(2n+1) + floor((X(2n) + X(2n+2)) / 2)

A 2-D level is 2D_SD (F.4.2): VER_SD (every column), then HOR_SD
(every row), then 2D_DEINTERLEAVE into ``LL``, ``HL`` (low vertically,
high horizontally), ``LH`` and ``HH``; the inverse is 2D_INTERLEAVE,
HOR_SR, VER_SR.  Pyramids list their levels coarsest first.

Computed in int64 with ``torch.div(..., rounding_mode="floor")``, on
whatever device the input is, one block of frames per call.  ``dtype``
sets another arithmetic for the check's control: in a floating dtype the
floors go, and with them the rounding offset they carry (``+ 2``), which
is the float 5/3 lifting.  This module gives the 2-D pair only.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

#: samples the 5-3 reads beyond each end of a signal
HALO = 2


def _extend(y: torch.Tensor, dim: int) -> torch.Tensor:
    """1D_EXTR: ``y`` along ``dim`` with :data:`HALO` samples of periodic
    symmetric extension on each side (``N >= 2``)."""
    n = y.shape[dim]
    period = 2 * (n - 1)
    idx = torch.arange(-HALO, n + HALO, device=y.device) % period
    idx = torch.where(idx >= n, period - idx, idx)
    return y.index_select(dim, idx)


def _floor_div(a: torch.Tensor, k: int, offset: int) -> torch.Tensor:
    """``floor((a + offset) / k)`` on integers; ``a / k`` on floats."""
    if a.is_floating_point():
        return a / k
    return torch.div(a + offset, k, rounding_mode="floor")


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    dim = dim % even.dim()
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(even.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _sd(x: torch.Tensor, dim: int) -> torch.Tensor:
    """1D_SD along ``dim``: the interleaved coefficients ``Y``."""
    e = _extend(x, dim).movedim(dim, -1)
    m = x.shape[dim] // 2
    ev, od = e[..., 0::2], e[..., 1::2]    # X(2k - 2), X(2k - 1)
    # Y(2n+1) for n = -1 .. m-1, then Y(2n) for n = 0 .. m-1
    y_odd = od[..., :m + 1] - _floor_div(ev[..., :m + 1] + ev[..., 1:m + 2],
                                         2, 0)
    y_even = ev[..., 1:m + 1] + _floor_div(y_odd[..., :m] + y_odd[..., 1:],
                                           4, 2)
    return _interleave(y_even, y_odd[..., 1:], -1).movedim(-1, dim)


def _sr(y: torch.Tensor, dim: int) -> torch.Tensor:
    """1D_SR along ``dim``: the signal ``X`` of interleaved ``Y``."""
    e = _extend(y, dim).movedim(dim, -1)
    m = y.shape[dim] // 2
    ev, od = e[..., 0::2], e[..., 1::2]    # Y(2k - 2), Y(2k - 1)
    # X(2n) for n = 0 .. m, then X(2n+1) for n = 0 .. m-1
    x_even = ev[..., 1:m + 2] - _floor_div(od[..., :m + 1] + od[..., 1:m + 2],
                                           4, 2)
    x_odd = od[..., 1:m + 1] + _floor_div(x_even[..., :m] + x_even[..., 1:],
                                          2, 0)
    return _interleave(x_even[..., :m], x_odd, -1).movedim(-1, dim)


def level2(x: torch.Tensor):
    """2D_SD of ``(..., H, W)``: ``(LL, HL, LH, HH)``."""
    y = _sd(_sd(x, -2), -1)
    return (y[..., 0::2, 0::2], y[..., 0::2, 1::2], y[..., 1::2, 0::2],
            y[..., 1::2, 1::2])


def unlevel2(ll, hl, lh, hh) -> torch.Tensor:
    """2D_SR: the inverse of :func:`level2`."""
    top = _interleave(ll, hl, -1)
    bottom = _interleave(lh, hh, -1)
    return _sr(_sr(_interleave(top, bottom, -2), -1), -2)


def dwt2(x: torch.Tensor, levels: int, dtype: torch.dtype = torch.int64):
    """``(LL, [(HL, LH, HH) per level, coarsest first])`` of a block of
    images ``(..., H, W)``, computed in ``dtype``."""
    details: List[Tuple[torch.Tensor, ...]] = []
    cur = x.to(dtype)
    for _ in range(levels):
        cur, hl, lh, hh = level2(cur)
        details.append((hl, lh, hh))
    return cur, details[::-1]


def idwt2(ll: torch.Tensor, details: Sequence[Sequence[torch.Tensor]],
          dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Inverse of :func:`dwt2`, computed in ``dtype``."""
    cur = ll.to(dtype)
    for hl, lh, hh in details:
        cur = unlevel2(cur, hl.to(dtype), lh.to(dtype), hh.to(dtype))
    return cur
