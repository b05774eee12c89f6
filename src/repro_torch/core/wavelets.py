"""Wavelet definitions: lifting factorizations of CDF 5/3, CDF 9/7, DD 13/7.

A wavelet is given by K predict/update pairs plus a scaling factor zeta:

    forward 1-D lifting on polyphase components (s = even, d = odd):
        for k in 1..K:
            d += P^(k) * s        (predict)
            s += U^(k) * d        (update)
        s *= zeta;  d *= 1/zeta

Polynomials follow the paper's convention  G(z) = sum_k g_k z^{-k}  with
(G s)[n] = sum_k g_k s[n-k]; a tap at k = -1 therefore reads the *next*
sample s[n+1].

The three wavelets are the ones evaluated by the paper (Table 1):

* CDF 5/3  (LeGall; JPEG 2000 lossless)   — K=1, 2-tap P and U.
* CDF 9/7  (Cohen-Daubechies-Feauveau [3]; JPEG 2000 lossy) — K=2.
* DD 13/7  (Deslauriers-Dubuc interpolating, Sweldens [14]) — K=1,
  4-tap P and U.

Beside them, :data:`REVERSIBLE` holds the integer-to-integer wavelets of
lossless coding: ``rev53``, the reversible 5-3 of ISO/IEC 15444-1
Annex F (JPEG 2000 lossless), whose floored lifting steps map int32
samples to int32 coefficients and back exactly.  They run only through
the integer path (:mod:`repro_torch.core.reversible`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core import poly as P


@dataclasses.dataclass(frozen=True)
class LiftingPair:
    """One predict/update pair, as 1-D tap dicts {k: g_k}."""

    predict: Dict[int, float]
    update: Dict[int, float]


@dataclasses.dataclass(frozen=True)
class Wavelet:
    name: str
    pairs: Tuple[LiftingPair, ...]
    zeta: float  # scaling: s *= zeta, d *= 1/zeta

    @property
    def K(self) -> int:
        return len(self.pairs)

    def analysis_filters(self) -> Tuple[Dict[int, float], Dict[int, float]]:
        """Derive the equivalent (low, high) analysis filter banks.

        Returns taps {k: h_k} on the *original* (non-polyphase) signal such
        that  s[n] = sum_k h_k x[2n - k]  (after subsample by 2) and
        similarly g for the detail channel d[n] = sum_k g_k x[2n + 1 - k].

        Used only for validation against published filter coefficients.
        """
        # 2x2 polyphase matrix over z (1-D), rows [s; d], cols [even; odd].
        # Start from identity: s = x_e, d = x_o.
        se: Dict[int, float] = {0: 1.0}
        so: Dict[int, float] = {}
        de: Dict[int, float] = {}
        do: Dict[int, float] = {0: 1.0}

        def _mac(dst_e, dst_o, src_e, src_o, taps):
            for k, c in taps.items():
                for kk, cc in src_e.items():
                    dst_e[k + kk] = dst_e.get(k + kk, 0.0) + c * cc
                for kk, cc in src_o.items():
                    dst_o[k + kk] = dst_o.get(k + kk, 0.0) + c * cc

        for pair in self.pairs:
            _mac(de, do, se, so, pair.predict)   # d += P s
            _mac(se, so, de, do, pair.update)    # s += U d
        se = {k: c * self.zeta for k, c in se.items()}
        so = {k: c * self.zeta for k, c in so.items()}
        de = {k: c / self.zeta for k, c in de.items()}
        do = {k: c / self.zeta for k, c in do.items()}

        # Recompose onto the original grid: x_e[n - k] = x[2n - 2k],
        # x_o[n - k] = x[2n + 1 - 2k].
        low: Dict[int, float] = {}
        high: Dict[int, float] = {}
        for k, c in se.items():
            low[2 * k] = low.get(2 * k, 0.0) + c
        for k, c in so.items():
            low[2 * k - 1] = low.get(2 * k - 1, 0.0) + c
        # d[n] reads x[2n+1 - ...]: express relative to x[2n+1]
        for k, c in de.items():
            high[2 * k + 1] = high.get(2 * k + 1, 0.0) + c
        for k, c in do.items():
            high[2 * k] = high.get(2 * k, 0.0) + c
        low = {k: v for k, v in low.items() if abs(v) > 1e-12}
        high = {k: v for k, v in high.items() if abs(v) > 1e-12}
        return low, high


# ---------------------------------------------------------------------------
# CDF 5/3 (LeGall).  P(z) = -1/2 (1 + z),  U(z) = 1/4 (1 + z^-1).
#   d[n] = x_o[n] - (x_e[n] + x_e[n+1]) / 2
#   s[n] = x_e[n] + (d[n-1] + d[n]) / 4
# ---------------------------------------------------------------------------
CDF53 = Wavelet(
    name="cdf53",
    pairs=(
        LiftingPair(predict={0: -0.5, -1: -0.5}, update={0: 0.25, 1: 0.25}),
    ),
    zeta=1.0,
)

# ---------------------------------------------------------------------------
# CDF 9/7 (JPEG 2000 lossy).  Two pairs (K=2), Daubechies-Sweldens [4]
# constants.  zeta chosen to match the published analysis bank with
# DC(low)=1, Nyquist(high)=2 convention used in JPEG 2000 implementations.
# ---------------------------------------------------------------------------
_ALPHA = -1.586134342059924
_BETA = -0.052980118572961
_GAMMA = 0.882911075530934
_DELTA = 0.443506852043971
_KAPPA = 1.230174104914001

CDF97 = Wavelet(
    name="cdf97",
    pairs=(
        LiftingPair(predict={0: _ALPHA, -1: _ALPHA}, update={0: _BETA, 1: _BETA}),
        LiftingPair(predict={0: _GAMMA, -1: _GAMMA}, update={0: _DELTA, 1: _DELTA}),
    ),
    zeta=1.0 / _KAPPA,
)

# ---------------------------------------------------------------------------
# DD 13/7 (Deslauriers-Dubuc (4,2)-interpolating, Sweldens [14]).
#   d[n] = x_o[n] + ( x_e[n-1] - 9 x_e[n] - 9 x_e[n+1] + x_e[n+2] ) / 16
#   s[n] = x_e[n] + ( -d[n-2] + 9 d[n-1] + 9 d[n] - d[n+1] ) / 32
# Analysis filters have 13 (low) and 7 (high) taps.
# ---------------------------------------------------------------------------
DD137 = Wavelet(
    name="dd137",
    pairs=(
        LiftingPair(
            predict={1: 1 / 16, 0: -9 / 16, -1: -9 / 16, -2: 1 / 16},
            update={2: -1 / 32, 1: 9 / 32, 0: 9 / 32, -1: -1 / 32},
        ),
    ),
    zeta=1.0,
)

WAVELETS: Dict[str, Wavelet] = {w.name: w for w in (CDF53, CDF97, DD137)}


@dataclasses.dataclass(frozen=True)
class ReversibleWavelet:
    """An integer lifting pair with floors (ISO/IEC 15444-1 Annex F):

        d[n] -= (s[n] + s[n+1]) >> predict_shift
        s[n] += (d[n-1] + d[n] + update_round) >> update_shift

    on int32 polyphase components (``>>`` floors), with no scaling.  The
    inverse undoes the two steps in reverse order, exactly."""

    name: str
    predict_shift: int
    update_shift: int
    update_round: int


# ---------------------------------------------------------------------------
# Reversible 5-3 (ISO/IEC 15444-1 Annex F, F.3.8.2 / F.4.8.2):
#   d[n] = x[2n+1] - floor((x[2n] + x[2n+2]) / 2)
#   s[n] = x[2n]   + floor((d[n-1] + d[n] + 2) / 4)
# ---------------------------------------------------------------------------
REV53 = ReversibleWavelet(name="rev53", predict_shift=1, update_shift=2,
                          update_round=2)

REVERSIBLE: Dict[str, ReversibleWavelet] = {w.name: w for w in (REV53,)}


def is_reversible(name: str) -> bool:
    """Whether ``name`` is an integer-to-integer wavelet."""
    return name in REVERSIBLE


def get_wavelet(name: str) -> Wavelet:
    try:
        return WAVELETS[name]
    except KeyError:
        raise KeyError(
            f"unknown wavelet {name!r}; available: {sorted(WAVELETS)}"
        ) from None
