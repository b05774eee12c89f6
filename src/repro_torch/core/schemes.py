"""The paper's 2-D DWT calculation schemes as 4x4 polyphase-matrix sequences.

Every scheme is a *sequence of matrices*; applying one matrix is one "step"
(one barrier: one launch of the window kernel and one round trip of the
four planes through device memory).  All
schemes are algebraically different factorizations of the same product, so
they compute identical coefficients — the paper's central premise, and our
central test invariant.

Component ordering of the polyphase vector (fixed everywhere):

    x1 = x[0::2, 0::2]   (even row, even col)            -> LL after fwd
    x2 = x[0::2, 1::2]   (even row, odd  col; horiz.-odd) -> HL (horiz. detail)
    x3 = x[1::2, 0::2]   (odd  row, even col; vert.-odd)  -> LH (vert. detail)
    x4 = x[1::2, 1::2]   (odd  row, odd  col)             -> HH

Horizontal lifting steps pair (x1,x2) and (x3,x4); vertical steps pair
(x1,x3) and (x2,x4) — exactly the paper's T_P^H / T_P^V / S_U^H / S_U^V.

Schemes (paper Section 2-4):

    sep-conv      N^V | N^H                          2 steps
    sep-lifting   S_U^V | S_U^H | T_P^V | T_P^H      4 steps per pair
    sep-polyconv  (S^H T^H), (S^V T^V) per pair      2 steps per pair
    ns-conv       N = N^V N^H                        1 step
    ns-polyconv   N_{P,U} = (S^V S^H)(T^V T^H)       1 step per pair
    ns-lifting    S_U | T_P  (spatial 2-D steps)     2 steps per pair

The final 1/zeta scaling is a diagonal (constant) matrix and is fused into
the last step of every scheme, matching the paper's treatment (scaling never
contributes a barrier).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core import poly as P
from repro_torch.core.wavelets import Wavelet, get_wavelet

SCHEMES = (
    "sep-conv",
    "sep-lifting",
    "sep-polyconv",
    "ns-conv",
    "ns-polyconv",
    "ns-lifting",
)


# ---------------------------------------------------------------------------
# Elementary 2-D lifting matrices
# ---------------------------------------------------------------------------

def predict_h(p: P.Poly) -> P.Matrix:
    """T_P^H: x2 += P x1, x4 += P x3  (P horizontal)."""
    m = P.identity()
    m[1][0] = dict(p)
    m[3][2] = dict(p)
    return m


def predict_v(p: P.Poly) -> P.Matrix:
    """T_P^V: x3 += P* x1, x4 += P* x2  (P* vertical)."""
    pt = P.transpose(p)
    m = P.identity()
    m[2][0] = dict(pt)
    m[3][1] = dict(pt)
    return m


def update_h(u: P.Poly) -> P.Matrix:
    """S_U^H: x1 += U x2, x3 += U x4."""
    m = P.identity()
    m[0][1] = dict(u)
    m[2][3] = dict(u)
    return m


def update_v(u: P.Poly) -> P.Matrix:
    """S_U^V: x1 += U* x3, x2 += U* x4."""
    ut = P.transpose(u)
    m = P.identity()
    m[0][2] = dict(ut)
    m[1][3] = dict(ut)
    return m


def scaling_matrix(zeta: float) -> P.Matrix:
    """Tensor product of the 1-D scalings (s *= zeta, d *= 1/zeta)."""
    return P.diagonal([zeta * zeta, 1.0, 1.0, 1.0 / (zeta * zeta)])


def scaling_matrix_h(zeta: float) -> P.Matrix:
    return P.diagonal([zeta, 1.0 / zeta, zeta, 1.0 / zeta])


def scaling_matrix_v(zeta: float) -> P.Matrix:
    return P.diagonal([zeta, zeta, 1.0 / zeta, 1.0 / zeta])


# ---------------------------------------------------------------------------
# Scheme construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scheme:
    """A DWT calculation scheme: an ordered sequence of matrix steps.

    ``steps[0]`` is applied first.  ``len(steps)`` is the paper's "number of
    steps" (= barriers = kernel launches under ``fuse="none"``).
    """

    name: str
    wavelet: str
    steps: Tuple[Tuple[P.Matrix, str], ...]  # (matrix, step label)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_ops(self) -> int:
        return sum(P.count_ops(m) for m, _ in self.steps)

    @property
    def max_halo(self) -> int:
        return max(P.matrix_halo(m) for m, _ in self.steps)

    def total_matrix(self) -> P.Matrix:
        return P.matmul_seq([m for m, _ in self.steps])


def _pair_polys(w: Wavelet) -> List[Tuple[P.Poly, P.Poly]]:
    return [
        (P.from_taps_1d(pair.predict, "m"), P.from_taps_1d(pair.update, "m"))
        for pair in w.pairs
    ]


def _fuse_scaling(steps: List[Tuple[P.Matrix, str]], zeta: float,
                  ) -> List[Tuple[P.Matrix, str]]:
    if abs(zeta - 1.0) < 1e-12:
        return steps
    m, label = steps[-1]
    return steps[:-1] + [(P.matmul(scaling_matrix(zeta), m), label)]


def build_scheme(wavelet: str | Wavelet, scheme: str) -> Scheme:
    """Construct the matrix sequence for one of the paper's six schemes."""
    w = get_wavelet(wavelet) if isinstance(wavelet, str) else wavelet
    pp = _pair_polys(w)
    steps: List[Tuple[P.Matrix, str]] = []

    if scheme == "sep-lifting":
        for k, (p, u) in enumerate(pp):
            steps += [
                (predict_h(p), f"T^H[{k}]"),
                (predict_v(p), f"T^V[{k}]"),
                (update_h(u), f"S^H[{k}]"),
                (update_v(u), f"S^V[{k}]"),
            ]
        steps = _fuse_scaling(steps, w.zeta)

    elif scheme == "sep-conv":
        nh = P.identity()
        nv = P.identity()
        for p, u in pp:
            nh = P.matmul(update_h(u), P.matmul(predict_h(p), nh))
            nv = P.matmul(update_v(u), P.matmul(predict_v(p), nv))
        nh = P.matmul(scaling_matrix_h(w.zeta), nh)
        nv = P.matmul(scaling_matrix_v(w.zeta), nv)
        steps = [(nh, "N^H"), (nv, "N^V")]

    elif scheme == "sep-polyconv":
        for k, (p, u) in enumerate(pp):
            nh = P.matmul(update_h(u), predict_h(p))
            nv = P.matmul(update_v(u), predict_v(p))
            steps += [(nh, f"N^H[{k}]"), (nv, f"N^V[{k}]")]
        steps = _fuse_scaling(steps, w.zeta)

    elif scheme == "ns-conv":
        nh = P.identity()
        nv = P.identity()
        for p, u in pp:
            nh = P.matmul(update_h(u), P.matmul(predict_h(p), nh))
            nv = P.matmul(update_v(u), P.matmul(predict_v(p), nv))
        n = P.matmul(scaling_matrix(w.zeta), P.matmul(nv, nh))
        steps = [(n, "N")]

    elif scheme == "ns-polyconv":
        for k, (p, u) in enumerate(pp):
            t2 = P.matmul(predict_v(p), predict_h(p))     # T_P spatial
            s2 = P.matmul(update_v(u), update_h(u))       # S_U spatial
            steps.append((P.matmul(s2, t2), f"N_PU[{k}]"))
        steps = _fuse_scaling(steps, w.zeta)

    elif scheme == "ns-lifting":
        for k, (p, u) in enumerate(pp):
            t2 = P.matmul(predict_v(p), predict_h(p))     # T_P
            s2 = P.matmul(update_v(u), update_h(u))       # S_U
            steps += [(t2, f"T[{k}]"), (s2, f"S[{k}]")]
        steps = _fuse_scaling(steps, w.zeta)

    else:
        raise ValueError(f"unknown scheme {scheme!r}; available: {SCHEMES}")

    return Scheme(name=scheme, wavelet=w.name, steps=tuple(steps))


def build_inverse_scheme(wavelet: str | Wavelet, scheme: str) -> Scheme:
    """Inverse transform, factored in the same style as ``scheme``.

    Lifting factors invert exactly (T_P^{-1} = T_{-P}); products invert as
    reversed products of inverses, so every scheme family has a closed-form
    inverse with the same step structure.
    """
    w = get_wavelet(wavelet) if isinstance(wavelet, str) else wavelet
    pp = _pair_polys(w)
    neg = [(P.pscale(p, -1.0), P.pscale(u, -1.0)) for p, u in pp]
    inv_zeta = 1.0 / w.zeta
    steps: List[Tuple[P.Matrix, str]] = []

    if scheme == "sep-lifting":
        # reverse order: undo scaling, then S^V, S^H, T^V, T^H per pair
        # (reversed pair order).
        first = True
        for k in reversed(range(len(pp))):
            np_, nu = neg[k]
            sub = [
                (update_v(nu), f"S^V[{k}]^-1"),
                (update_h(nu), f"S^H[{k}]^-1"),
                (predict_v(np_), f"T^V[{k}]^-1"),
                (predict_h(np_), f"T^H[{k}]^-1"),
            ]
            if first:
                m, lbl = sub[0]
                sub[0] = (P.matmul(m, scaling_matrix(inv_zeta)), lbl)
                first = False
            steps += sub

    elif scheme in ("sep-conv", "ns-conv"):
        nh = P.identity()
        nv = P.identity()
        for k in reversed(range(len(pp))):
            np_, nu = neg[k]
            nh = P.matmul(predict_h(np_), P.matmul(update_h(nu), nh))
            nv = P.matmul(predict_v(np_), P.matmul(update_v(nu), nv))
        nh = P.matmul(nh, scaling_matrix_h(inv_zeta))
        nv = P.matmul(nv, scaling_matrix_v(inv_zeta))
        if scheme == "sep-conv":
            steps = [(nv, "N^V^-1"), (nh, "N^H^-1")]
        else:
            steps = [(P.matmul(nh, nv), "N^-1")]

    elif scheme in ("sep-polyconv", "ns-polyconv", "ns-lifting"):
        first = True
        for k in reversed(range(len(pp))):
            np_, nu = neg[k]
            s2 = P.matmul(update_v(nu), update_h(nu))
            t2 = P.matmul(predict_v(np_), predict_h(np_))
            if scheme == "ns-lifting":
                sub = [(s2, f"S[{k}]^-1"), (t2, f"T[{k}]^-1")]
            elif scheme == "ns-polyconv":
                sub = [(P.matmul(t2, s2), f"N_PU[{k}]^-1")]
            else:  # sep-polyconv
                nh = P.matmul(predict_h(np_), update_h(nu))
                nv = P.matmul(predict_v(np_), update_v(nu))
                sub = [(nv, f"N^V[{k}]^-1"), (nh, f"N^H[{k}]^-1")]
            if first:
                m, lbl = sub[0]
                sub[0] = (P.matmul(m, scaling_matrix(inv_zeta)), lbl)
                first = False
            steps += sub
    else:
        raise ValueError(f"unknown scheme {scheme!r}; available: {SCHEMES}")

    return Scheme(name=scheme + "^-1", wavelet=w.name, steps=tuple(steps))


# ---------------------------------------------------------------------------
# Numeric application (torch reference; periodic boundary)
# ---------------------------------------------------------------------------

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def to_planes(x: torch.Tensor) -> Planes:
    """Split an image (..., H, W) into the four polyphase planes (strided
    views of ``x``; no copy)."""
    return (
        x[..., 0::2, 0::2],
        x[..., 0::2, 1::2],
        x[..., 1::2, 0::2],
        x[..., 1::2, 1::2],
    )


def from_planes(planes: Planes) -> torch.Tensor:
    """Interleave four (..., H/2, W/2) planes back into (..., H, W)."""
    x1, x2, x3, x4 = planes
    top = torch.stack([x1, x2], dim=-1).reshape(*x1.shape[:-1], -1)
    bot = torch.stack([x3, x4], dim=-1).reshape(*x3.shape[:-1], -1)
    out = torch.stack([top, bot], dim=-2)
    return out.reshape(*top.shape[:-2], -1, top.shape[-1])


@functools.lru_cache(maxsize=4096)
def coef(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``: the value a multiply in that dtype uses
    (the reference's weak-typed scalars round the same way)."""
    return float(torch.tensor(c, dtype=dtype))


def apply_poly(p: P.Poly, x: torch.Tensor) -> torch.Tensor:
    """(G x)[n, m] = sum_k g_k x[n - k_n, m - k_m], periodic boundary."""
    if not p:
        return torch.zeros_like(x)
    acc = None
    for (km, kn), c in sorted(p.items()):
        term = x
        if kn != 0:
            term = torch.roll(term, kn, dims=-2)
        if km != 0:
            term = torch.roll(term, km, dims=-1)
        term = term * coef(c, x.dtype)
        acc = term if acc is None else acc + term
    return acc


def apply_matrix(m: P.Matrix, planes: Planes) -> Planes:
    out = []
    for i in range(4):
        acc = None
        for j in range(4):
            if not m[i][j]:
                continue
            term = apply_poly(m[i][j], planes[j])
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(planes[0]))
    return tuple(out)


def apply_scheme(scheme: Scheme, planes: Planes) -> Planes:
    for m, _ in scheme.steps:
        planes = apply_matrix(m, planes)
    return planes


def inverse(subbands: Planes, wavelet: str = "cdf97",
            scheme: str = "ns-polyconv") -> torch.Tensor:
    """Single-level 2-D inverse DWT: (LL, HL, LH, HH) -> image."""
    s = build_inverse_scheme(wavelet, scheme)
    return from_planes(apply_scheme(s, subbands))
