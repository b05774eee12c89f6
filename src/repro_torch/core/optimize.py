"""Section 5 optimization: split P = P0 + P1, U = U0 + U1 (P0, U0 constant).

Constant polynomials never access a neighbouring unit's results, so they can
be evaluated *without a barrier*: the constant parts are substituted into
separable lifting steps (cheapest structure, paper Figure 6) and fused into
the adjacent non-separable kernel — in the window kernel that means the
constant matrices are applied **elementwise** on the already-loaded shared
memory window (pre) or on the output block (post), adding zero halo and
zero device-memory traffic.

An optimized scheme step is therefore a triple

    (pre: constant matrices, main: one neighbour-reading matrix, post: ...)

with the same number of steps (barriers / kernel launches) as the raw scheme
but fewer arithmetic operations.  ``num_ops`` of the optimized schemes
reproduces the OpenCL column of the paper's Table 1 (see
benchmarks/table1_ops.py); the platform adaptation rule is

    ops(platform) = min(ops_raw, ops_optimized)

— for DD 13/7's large lifting filters the split does not pay off for some
schemes, and the paper likewise reports the raw counts there.

Algebraic basis (verified in tests): the 2-D predict/update families are
one-parameter abelian groups, T_{Pa} T_{Pb} = T_{Pa+Pb} and likewise for S,
so  T_P = T_{P1} T_{P0}  and constants can be pulled to the ends of each
pair's chain  C_k = S_{U0k} S_{U1k} T_{P1k} T_{P0k}.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import poly as P
from repro_torch.core import schemes as S
from repro_torch.core.wavelets import Wavelet, get_wavelet


@dataclasses.dataclass(frozen=True)
class OptStep:
    """One barrier-delimited step of an optimized scheme.

    ``pre`` and ``post`` contain only constant (halo-0, elementwise)
    matrices; ``main`` is the single neighbour-reading matrix (may be None
    when a step degenerates to constants only).
    """

    pre: Tuple[P.Matrix, ...]
    main: Optional[P.Matrix]
    post: Tuple[P.Matrix, ...]
    label: str = ""

    @property
    def num_ops(self) -> int:
        n = sum(P.count_ops(m) for m in self.pre)
        n += P.count_ops(self.main) if self.main is not None else 0
        n += sum(P.count_ops(m) for m in self.post)
        return n

    @property
    def halo(self) -> int:
        return P.matrix_halo(self.main) if self.main is not None else 0

    def matrices(self) -> List[P.Matrix]:
        out = list(self.pre)
        if self.main is not None:
            out.append(self.main)
        out.extend(self.post)
        return out

    def total_matrix(self) -> P.Matrix:
        return P.matmul_seq(self.matrices())


@dataclasses.dataclass(frozen=True)
class OptScheme:
    name: str
    wavelet: str
    steps: Tuple[OptStep, ...]

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def num_ops(self) -> int:
        return sum(st.num_ops for st in self.steps)

    @property
    def max_halo(self) -> int:
        return max(st.halo for st in self.steps)

    def total_matrix(self) -> P.Matrix:
        return P.matmul_seq([m for st in self.steps for m in st.matrices()])


def _split_pairs(w: Wavelet):
    """Per pair: (P0, P1, U0, U1) with P = P0+P1, U = U0+U1, P0/U0 const."""
    out = []
    for pair in w.pairs:
        p = P.from_taps_1d(pair.predict, "m")
        u = P.from_taps_1d(pair.update, "m")
        p0, p1 = P.split_const(p)
        u0, u1 = P.split_const(u)
        out.append((p0, p1, u0, u1))
    return out


def build_optimized(wavelet: str | Wavelet, scheme: str) -> OptScheme:
    """Optimized (Section 5) variant of ``scheme``; same values, same number
    of steps, fewer operations."""
    w = get_wavelet(wavelet) if isinstance(wavelet, str) else wavelet
    sp = _split_pairs(w)
    K = len(sp)
    steps: List[OptStep] = []
    Z = S.scaling_matrix(w.zeta)
    has_z = abs(w.zeta - 1.0) > 1e-12

    def _zpost(post: List[P.Matrix]) -> Tuple[P.Matrix, ...]:
        return tuple(post + ([Z] if has_z else []))

    if scheme == "sep-lifting":
        for k, (p0, p1, u0, u1) in enumerate(sp):
            steps += [
                OptStep((S.predict_h(p0),), S.predict_h(p1), (), f"T^H[{k}]"),
                OptStep((S.predict_v(p0),), S.predict_v(p1), (), f"T^V[{k}]"),
                OptStep((S.update_h(u0),), S.update_h(u1), (), f"S^H[{k}]"),
                OptStep((S.update_v(u0),), S.update_v(u1), (), f"S^V[{k}]"),
            ]
        if has_z:
            last = steps[-1]
            steps[-1] = dataclasses.replace(last, post=_zpost(list(last.post)))

    elif scheme == "ns-lifting":
        for k, (p0, p1, u0, u1) in enumerate(sp):
            t_main = P.matmul(S.predict_v(p1), S.predict_h(p1))
            s_main = P.matmul(S.update_v(u1), S.update_h(u1))
            steps += [
                OptStep((S.predict_h(p0), S.predict_v(p0)), t_main, (),
                        f"T[{k}]"),
                OptStep((S.update_h(u0), S.update_v(u0)), s_main,
                        _zpost([]) if k == K - 1 else (), f"S[{k}]"),
            ]

    elif scheme == "ns-polyconv":
        for k, (p0, p1, u0, u1) in enumerate(sp):
            main = P.matmul(
                P.matmul(S.update_v(u1), S.update_h(u1)),
                P.matmul(S.predict_v(p1), S.predict_h(p1)),
            )
            steps.append(OptStep(
                (S.predict_h(p0), S.predict_v(p0)),
                main,
                _zpost([S.update_h(u0), S.update_v(u0)]) if k == K - 1
                else (S.update_h(u0), S.update_v(u0)),
                f"N_PU[{k}]",
            ))

    elif scheme == "ns-conv":
        # chain C_k = S_{U0k} S_{U1k} T_{P1k} T_{P0k}; pull T_{P0,1} to pre
        # and S_{U0,K} to post, compose the interior into one matrix.
        interior = P.identity()
        for k, (p0, p1, u0, u1) in enumerate(sp):
            if k > 0:
                interior = P.matmul(
                    P.matmul(S.predict_v(p0), S.predict_h(p0)), interior)
            interior = P.matmul(
                P.matmul(S.predict_v(p1), S.predict_h(p1)), interior)
            interior = P.matmul(
                P.matmul(S.update_v(u1), S.update_h(u1)), interior)
            if k < K - 1:
                interior = P.matmul(
                    P.matmul(S.update_v(u0), S.update_h(u0)), interior)
        p0_first = sp[0][0]
        u0_last = sp[-1][2]
        steps = [OptStep(
            (S.predict_h(p0_first), S.predict_v(p0_first)),
            interior,
            _zpost([S.update_h(u0_last), S.update_v(u0_last)]),
            "N",
        )]

    elif scheme == "sep-conv":
        # per direction: pre = T_{P0,1}, post = S_{U0,K}, interior composed.
        def _dir(predict, update, zmat):
            interior = P.identity()
            for k, (p0, p1, u0, u1) in enumerate(sp):
                if k > 0:
                    interior = P.matmul(predict(p0), interior)
                interior = P.matmul(predict(p1), interior)
                interior = P.matmul(update(u1), interior)
                if k < K - 1:
                    interior = P.matmul(update(u0), interior)
            post = [update(sp[-1][2])] + ([zmat] if has_z else [])
            return OptStep((predict(sp[0][0]),), interior, tuple(post))

        steps = [
            dataclasses.replace(
                _dir(S.predict_h, S.update_h, S.scaling_matrix_h(w.zeta)),
                label="N^H"),
            dataclasses.replace(
                _dir(S.predict_v, S.update_v, S.scaling_matrix_v(w.zeta)),
                label="N^V"),
        ]

    elif scheme == "sep-polyconv":
        for k, (p0, p1, u0, u1) in enumerate(sp):
            is_last = k == K - 1
            main_h = P.matmul(S.update_h(u1), S.predict_h(p1))
            main_v = P.matmul(S.update_v(u1), S.predict_v(p1))
            steps += [
                OptStep((S.predict_h(p0),), main_h, (S.update_h(u0),),
                        f"N^H[{k}]"),
                OptStep((S.predict_v(p0),), main_v,
                        _zpost([S.update_v(u0)]) if is_last
                        else (S.update_v(u0),),
                        f"N^V[{k}]"),
            ]
    else:
        raise ValueError(f"unknown scheme {scheme!r}; available: {S.SCHEMES}")

    return OptScheme(name=scheme + "+opt", wavelet=w.name, steps=tuple(steps))


# ---------------------------------------------------------------------------
# Numeric application (reference path)
# ---------------------------------------------------------------------------

def apply_opt_step(st: OptStep, planes: S.Planes) -> S.Planes:
    for m in st.pre:
        planes = S.apply_matrix(m, planes)
    if st.main is not None:
        planes = S.apply_matrix(st.main, planes)
    for m in st.post:
        planes = S.apply_matrix(m, planes)
    return planes


def apply_opt_scheme(sch: OptScheme, planes: S.Planes) -> S.Planes:
    for st in sch.steps:
        planes = apply_opt_step(st, planes)
    return planes


def forward_optimized(x: torch.Tensor, wavelet: str = "cdf97",
                      scheme: str = "ns-polyconv") -> S.Planes:
    """Single-level 2-D DWT through the Section 5 reduced-operation
    scheme (pre, main, post matrices of each step); the same
    coefficients as :func:`repro_torch.core.schemes.forward`."""
    sch = build_optimized(wavelet, scheme)
    return apply_opt_scheme(sch, S.to_planes(x))


def table1_ops(wavelet: str, scheme: str) -> dict:
    """Steps and op counts in the paper's Table 1 convention.

    Scaling is excluded from op counts (the paper's lifting counts, e.g.
    CDF 9/7 separable lifting = 32, include no scaling terms), so counts are
    evaluated on a zeta=1 clone of the wavelet.  Platform adaptation:
    OpenCL-style ops = min(raw, optimized).
    """
    w = get_wavelet(wavelet)
    w1 = dataclasses.replace(w, zeta=1.0)
    raw = S.build_scheme(w1, scheme)
    opt = build_optimized(w1, scheme)
    return {
        "wavelet": wavelet,
        "scheme": scheme,
        "steps": raw.num_steps,
        "ops_raw": raw.num_ops,
        "ops_optimized": opt.num_ops,
        "ops_adapted": min(raw.num_ops, opt.num_ops),
    }
