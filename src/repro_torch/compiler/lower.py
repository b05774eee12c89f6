"""Lowering: StepSpec sequences -> :class:`~repro_torch.compiler.ir.TapProgram`.

The lowered (pass-free) program reproduces the reference package's raw
matrix walk (``_apply_steps_windows`` in its window kernel) term for term: one
``lincomb`` node per output row per matrix application, terms emitted
source-major (j = 0..3) with taps in sorted key order, exactly the
accumulation order of the reference loop.  Executing the lowered program
is therefore *bit-identical* to the raw walk in any floating dtype.

The fold pass lives here because it operates on matrices, before any
nodes exist: adjacent matrices of a step (the constant halo-0 ``pre`` /
``post`` factors around ``main``) — and, in a fused chain, adjacent whole
steps — are composed symbolically with :func:`repro_torch.core.poly.matmul`.
Folding is *cost-guarded*: the composed matrix replaces its factors only
when its tap count does not exceed theirs, so Section-5 splits (whose
whole point is that the split form is cheaper) are never re-expanded,
while genuinely redundant factorizations (diagonal scalings, unit-heavy
lifting factors) collapse.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core import poly as P
from repro_torch.compiler import ir


def _matrix_cost(m: P.Matrix) -> int:
    """Tap count of one matrix application (paper convention: unit
    diagonal entries are free)."""
    return P.count_ops(m)


def step_matrices(step) -> List[P.Matrix]:
    """The matrices of one StepSpec in application order."""
    out = list(step.pre)
    if step.main is not None:
        out.append(step.main)
    out.extend(step.post)
    return out


def fold_matrices(mats: Sequence[P.Matrix]) -> List[P.Matrix]:
    """Greedy pairwise symbolic folding, cost-guarded.

    Repeatedly composes an adjacent pair ``(a, b)`` into ``b @ a`` when the
    product's tap count is no larger than the pair's combined count, until
    no pair improves.  Identity factors vanish, diagonal scalings merge
    into their neighbours, and cheap lifting factors fuse — but a split
    that exists *because* it is cheaper (Section 5) is left alone.
    """
    mats = [m for m in mats]
    changed = True
    while changed and len(mats) > 1:
        changed = False
        costs = [_matrix_cost(m) for m in mats]
        for i in range(len(mats) - 1):
            prod = P.matmul(mats[i + 1], mats[i])  # mats[i] applied first
            if _matrix_cost(prod) <= costs[i] + costs[i + 1]:
                mats[i:i + 2] = [prod]
                changed = True
                break
    return mats


def lower_steps(steps: Sequence, fold: bool = False) -> ir.TapProgram:
    """Lower a StepSpec sequence (one fused kernel group) to a program.

    ``fold=False`` lowers the matrices exactly as the raw walk applies
    them (bit-identity reference); ``fold=True`` runs the symbolic fold
    pass first (within each step, then across adjacent steps of the
    group).
    """
    mats: List[P.Matrix] = []
    if fold:
        per_step = [fold_matrices(step_matrices(st)) for st in steps]
        flat = [m for ms in per_step for m in ms]
        mats = fold_matrices(flat)
    else:
        for st in steps:
            mats.extend(step_matrices(st))

    nodes: List[ir.Node] = [ir.Node(kind="input", j=j) for j in range(4)]
    cur: List[int] = [0, 1, 2, 3]
    for m in mats:
        nxt: List[int] = []
        for i in range(4):
            terms: List[ir.Term] = []
            for j in range(4):
                for (km, kn), c in sorted(m[i][j].items()):
                    terms.append(ir.Term(src=cur[j], km=km, kn=kn,
                                         c=float(c)))
            nodes.append(ir.Node(kind="lincomb", terms=tuple(terms)))
            nxt.append(len(nodes) - 1)
        cur = nxt
    return ir.program(nodes, cur)
