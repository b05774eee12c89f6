"""Bivariate Laurent-polynomial engine for 2-D polyphase matrices.

The paper describes every DWT calculation scheme as a sequence of 4x4
matrices whose entries are bivariate Laurent polynomials

    G(z_m, z_n) = sum_{k_m} sum_{k_n} g_{k_m,k_n} z_m^{-k_m} z_n^{-k_n}

where ``m`` indexes the horizontal axis (image columns) and ``n`` the
vertical axis (rows).  Applying a polynomial to a 2-D signal ``s`` is the
convolution  (G s)[n, m] = sum_k g_k s[n - k_n, m - k_m].

We represent a polynomial as a dict mapping ``(k_m, k_n) -> coefficient``
and a matrix step as a 4x4 nested tuple of polynomials.  The engine
supports exactly the algebra the paper uses: sums, products, transposition
(``G* (z_m, z_n) = G(z_n, z_m)``), matrix products, and the operation
count of Section 2 ("the number of distinct (in a column) terms of all
polynomials in all matrices, excluding units on diagonals").

Everything here is plain Python — it runs at plan-build time.  The
numeric application of a matrix to polyphase planes lives in
``repro_torch.core.schemes`` (torch rolls) and ``repro_torch.kernels``
(the CUDA window kernel).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Key = Tuple[int, int]  # (k_m horizontal, k_n vertical)
Poly = Dict[Key, float]

_EPS = 1e-12


def poly(d: Dict[Key, float] | None = None) -> Poly:
    return dict(d or {})


def const(c: float) -> Poly:
    """Constant polynomial c."""
    if abs(c) < _EPS:
        return {}
    return {(0, 0): float(c)}


ZERO: Poly = {}
ONE: Poly = {(0, 0): 1.0}


def from_taps_1d(taps: Dict[int, float], axis: str = "m") -> Poly:
    """Build a univariate polynomial along the given axis.

    ``taps[k] = g_k`` corresponds to the term ``g_k z^{-k}``, i.e. applying
    the polynomial to a signal uses sample ``s[n - k]``.
    """
    out: Poly = {}
    for k, c in taps.items():
        if abs(c) < _EPS:
            continue
        key = (k, 0) if axis == "m" else (0, k)
        out[key] = out.get(key, 0.0) + float(c)
    return prune(out)


def prune(p: Poly) -> Poly:
    return {k: c for k, c in p.items() if abs(c) > _EPS}


def padd(a: Poly, b: Poly) -> Poly:
    out = dict(a)
    for k, c in b.items():
        out[k] = out.get(k, 0.0) + c
    return prune(out)


def pscale(a: Poly, s: float) -> Poly:
    return prune({k: c * s for k, c in a.items()})


def pmul(a: Poly, b: Poly) -> Poly:
    out: Poly = {}
    for (ka_m, ka_n), ca in a.items():
        for (kb_m, kb_n), cb in b.items():
            key = (ka_m + kb_m, ka_n + kb_n)
            out[key] = out.get(key, 0.0) + ca * cb
    return prune(out)


def transpose(a: Poly) -> Poly:
    """G*(z_m, z_n) = G(z_n, z_m): swap the axes of every term."""
    return {(kn, km): c for (km, kn), c in a.items()}


def is_const(a: Poly) -> bool:
    return len(a) == 0 or (len(a) == 1 and (0, 0) in a)


def support(a: Poly) -> Tuple[int, int, int, int]:
    """(min_km, max_km, min_kn, max_kn) of the filter taps."""
    if not a:
        return (0, 0, 0, 0)
    kms = [k[0] for k in a]
    kns = [k[1] for k in a]
    return (min(kms), max(kms), min(kns), max(kns))


def halo(a: Poly) -> int:
    """Max absolute tap offset — the halo radius the filter needs."""
    mn_m, mx_m, mn_n, mx_n = support(a)
    return max(abs(mn_m), abs(mx_m), abs(mn_n), abs(mx_n))


# ---------------------------------------------------------------------------
# 4x4 polyphase matrices
# ---------------------------------------------------------------------------

Matrix = List[List[Poly]]  # 4x4


def identity() -> Matrix:
    return [[dict(ONE) if i == j else {} for j in range(4)] for i in range(4)]


def diagonal(scales: Sequence[float]) -> Matrix:
    m = [[{} for _ in range(4)] for _ in range(4)]
    for i, s in enumerate(scales):
        m[i][i] = const(s)
    return m


def matmul(a: Matrix, b: Matrix) -> Matrix:
    """Matrix product (a @ b): apply ``b`` first, then ``a``."""
    out: Matrix = [[{} for _ in range(4)] for _ in range(4)]
    for i in range(4):
        for j in range(4):
            acc: Poly = {}
            for k in range(4):
                if a[i][k] and b[k][j]:
                    acc = padd(acc, pmul(a[i][k], b[k][j]))
            out[i][j] = acc
    return out


def matmul_seq(mats: Sequence[Matrix]) -> Matrix:
    """Product of a sequence of matrices; ``mats[0]`` is applied FIRST.

    i.e. returns mats[-1] @ ... @ mats[0].
    """
    out = identity()
    for m in mats:
        out = matmul(m, out)
    return out


def matrix_halo(m: Matrix) -> int:
    return max(halo(p) for row in m for p in row)


def count_ops(m: Matrix) -> int:
    """Operation count per Section 2 of the paper.

    "the number of distinct (in a column) terms of all polynomials in all
    matrices, excluding units on diagonals"

    Each term of each polynomial is one multiply-accumulate; terms that are
    exact unit diagonal entries are free (identity pass-through).  "Distinct
    in a column" counts the union over rows of each column's terms once per
    (row, tap) — i.e. simply every non-identity tap.
    """
    n = 0
    for i in range(4):
        for j in range(4):
            p = m[i][j]
            for k, c in p.items():
                if i == j and k == (0, 0) and abs(c - 1.0) < _EPS:
                    continue  # unit on the diagonal
                n += 1
    return n


def count_ops_seq(mats: Sequence[Matrix]) -> int:
    return sum(count_ops(m) for m in mats)


def mat_transpose_polys(m: Matrix) -> Matrix:
    """Apply the * (axis-swap) operator to every entry (NOT a matrix
    transpose)."""
    return [[transpose(p) for p in row] for row in m]


def mat_allclose(a: Matrix, b: Matrix, tol: float = 1e-9) -> bool:
    for i in range(4):
        for j in range(4):
            keys = set(a[i][j]) | set(b[i][j])
            for k in keys:
                if abs(a[i][j].get(k, 0.0) - b[i][j].get(k, 0.0)) > tol:
                    return False
    return True


def mat_max_diff(a: Matrix, b: Matrix) -> float:
    d = 0.0
    for i in range(4):
        for j in range(4):
            keys = set(a[i][j]) | set(b[i][j])
            for k in keys:
                d = max(d, abs(a[i][j].get(k, 0.0) - b[i][j].get(k, 0.0)))
    return d


def split_const(p: Poly) -> Tuple[Poly, Poly]:
    """Split ``P = P0 + P1`` with ``P0`` the constant ((0,0)) part.

    This is the Section 5 optimization primitive: constant taps never access
    a neighbour's result, so they can be evaluated without a barrier.
    """
    p0 = {(0, 0): p[(0, 0)]} if (0, 0) in p else {}
    p1 = {k: c for k, c in p.items() if k != (0, 0)}
    return p0, p1
