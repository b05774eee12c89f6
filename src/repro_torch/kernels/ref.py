"""Torch oracle for the DWT kernels — Mallat filter-bank convolution.

Deliberately an *independent algorithm* from both the scheme engine
(:mod:`repro_torch.core.schemes`, polyphase matrices) and the window
kernel: each subband is computed by direct 2-D convolution with the
wavelet's analysis filter bank followed by subsampling (Mallat [10]), with
periodic boundary.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.wavelets import get_wavelet


def _filter_subsample(x: torch.Tensor, taps_v: Dict[int, float],
                      phase_v: int, taps_h: Dict[int, float],
                      phase_h: int) -> torch.Tensor:
    """y[u, v] = sum_{kn,km} tv[kn] th[km] x[2u+pv-kn, 2v+ph-km] (periodic)."""
    acc = None
    for kn, cv in sorted(taps_v.items()):
        rolled_v = torch.roll(x, kn - phase_v, dims=-2)
        for km, ch in sorted(taps_h.items()):
            t = torch.roll(rolled_v, km - phase_h, dims=-1)
            t = t[..., 0::2, 0::2] * (cv * ch)
            acc = t if acc is None else acc + t
    return acc


def dwt2_ref(x: torch.Tensor, wavelet: str = "cdf97"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Single-level 2-D DWT via the analysis filter bank: (LL, HL, LH, HH).

    HL carries horizontal detail (high-pass along columns of a row), LH
    vertical detail — matching the polyphase component ordering of
    :mod:`repro_torch.core.schemes`.
    """
    w = get_wavelet(wavelet)
    low, high = w.analysis_filters()
    ll = _filter_subsample(x, low, 0, low, 0)
    hl = _filter_subsample(x, low, 0, high, 1)
    lh = _filter_subsample(x, high, 1, low, 0)
    hh = _filter_subsample(x, high, 1, high, 1)
    return ll, hl, lh, hh


def idwt2_ref(subbands, wavelet: str = "cdf97") -> torch.Tensor:
    """Inverse via the lifting engine (exact); closes the loop in tests
    that start from the filter-bank forward."""
    from repro_torch.core import schemes as S
    return S.inverse(subbands, wavelet, "sep-lifting")
