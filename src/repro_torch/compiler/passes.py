"""Optimization passes over tap programs.

Pipeline (:func:`optimize_program`):

``exact``
    Dead-term pruning + dead-node elimination only.  Every surviving
    operation keeps its value, position and accumulation order, so the
    program stays **bit-identical** to the raw matrix walk (unit and
    negated-unit coefficients are strength-reduced by the executors,
    which is exact in IEEE-754: ``1.0*x == x`` and ``acc + (-1.0*x) ==
    acc - x`` bitwise).

``full``
    Adds the two reassociating passes:

    * **rank-1 factorization** — a group of terms reading one source is a
      bivariate Laurent polynomial; when its coefficient grid is a full
      outer product ``a(z_m) (x) b(z_n)`` the group is replaced by a 1-D
      horizontal pass (a new ``lincomb`` node computing ``a`` applied to
      the source) plus ``|b|`` vertical taps reading that node:
      ``|a| + |b|`` MACs instead of ``|a|*|b|``.
    * **CSE** — stage-1 filters are canonically normalized (unit
      coefficient at the largest-magnitude tap, scale pushed into the
      stage-2 taps) and shared across all consumers: the polyphase
      matrices of the merged schemes are built from products of a handful
      of 1-D lifting polynomials, so the same normalized factor shows up
      in many entries of many rows.  Univariate groups proportional to a
      shared factor collapse to a single scaled read.  Identical lincomb
      nodes are hash-consed.

    Factorizations are chosen globally: a stage-1 node is materialized
    only when the total MACs of its consumers (plus the node itself)
    beat the unfactored cost, so the pass never increases the op count.

    Reassociation changes floating-point rounding at the last-ulp level;
    parity with the exact path is property-tested to fp32 tolerances.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.compiler import ir

_COEFF_TOL = 1e-10   # relative tolerance for rank-1 proportionality
_KEY_DIGITS = 12     # significant digits in CSE factor keys


# ---------------------------------------------------------------------------
# Generic cleanups
# ---------------------------------------------------------------------------

def prune_dead_terms(prog: ir.TapProgram) -> ir.TapProgram:
    """Drop exact-zero terms (dead taps contribute nothing)."""
    nodes = []
    for nd in prog.nodes:
        if nd.kind == "lincomb":
            terms = tuple(t for t in nd.terms if t.c != 0.0)
            nd = dataclasses.replace(nd, terms=terms)
        nodes.append(nd)
    return ir.program(nodes, prog.outputs)


def eliminate_dead_nodes(prog: ir.TapProgram) -> ir.TapProgram:
    """Drop nodes unreachable from the outputs; renumber the rest.

    Input nodes are always kept so executors can bind planes by ``j``.
    """
    live = [False] * len(prog.nodes)
    stack = list(prog.outputs)
    while stack:
        i = stack.pop()
        if live[i]:
            continue
        live[i] = True
        for t in prog.nodes[i].terms:
            stack.append(t.src)
    remap: Dict[int, int] = {}
    nodes: List[ir.Node] = []
    for i, nd in enumerate(prog.nodes):
        if not (live[i] or nd.kind == "input"):
            continue
        remap[i] = len(nodes)
        if nd.kind == "lincomb":
            nd = dataclasses.replace(
                nd, terms=tuple(dataclasses.replace(t, src=remap[t.src])
                                for t in nd.terms))
        nodes.append(nd)
    return ir.program(nodes, tuple(remap[o] for o in prog.outputs))


def hash_cons(prog: ir.TapProgram) -> ir.TapProgram:
    """Merge structurally identical nodes (classic value-numbering CSE)."""
    seen: Dict[Tuple, int] = {}
    remap: Dict[int, int] = {}
    nodes: List[ir.Node] = []
    for i, nd in enumerate(prog.nodes):
        if nd.kind == "lincomb":
            nd = dataclasses.replace(
                nd, terms=tuple(dataclasses.replace(t, src=remap[t.src])
                                for t in nd.terms))
            key = ("l", nd.terms)
        else:
            key = ("i", nd.j)
        if key in seen and nd.kind == "lincomb" and nd.terms:
            remap[i] = seen[key]
            continue
        seen.setdefault(key, len(nodes))
        remap[i] = len(nodes)
        nodes.append(nd)
    return ir.program(nodes, tuple(remap[o] for o in prog.outputs))


# ---------------------------------------------------------------------------
# Rank-1 factorization + factor CSE
# ---------------------------------------------------------------------------

def _round_sig(c: float, digits: int = _KEY_DIGITS) -> float:
    """Round to significant digits — CSE keys must absorb last-ulp noise
    between factors derived from different symbolic products."""
    return float(f"%.{digits}e" % c)


def _factor_key(src: int, axis: str,
                taps: Sequence[Tuple[int, float]]) -> Tuple:
    return (src, axis, tuple((k, _round_sig(c)) for k, c in taps))


@dataclasses.dataclass
class _Group:
    """All terms of one lincomb node reading one source."""

    node: int
    src: int
    taps: Dict[Tuple[int, int], float]

    def factorization(self) -> Optional[Tuple[Tuple, List, List]]:
        """``(key, a_norm, b)`` if the coefficient grid is a complete,
        proportional outer product over a genuinely 2-D support."""
        kms = sorted({km for km, _ in self.taps})
        kns = sorted({kn for _, kn in self.taps})
        if len(kms) < 2 or len(kns) < 2:
            return None
        if len(self.taps) != len(kms) * len(kns):
            return None  # holes in the grid: not an outer product
        kn0 = kns[0]
        a = [self.taps[(km, kn0)] for km in kms]
        scale = max(a, key=abs)
        a_norm = [c / scale for c in a]
        km_ref = kms[a.index(scale)]
        b = [self.taps[(km_ref, kn)] for kn in kns]
        lim = _COEFF_TOL * max(abs(c) for c in self.taps.values())
        for i, km in enumerate(kms):
            for jj, kn in enumerate(kns):
                if abs(self.taps[(km, kn)] - a_norm[i] * b[jj]) > lim:
                    return None
        a_taps = list(zip(kms, a_norm))
        return (_factor_key(self.src, "m", a_taps), a_taps,
                list(zip(kns, b)))

    def scaled_match(self, keys: Dict[Tuple, int]) -> Optional[Tuple[Tuple,
                                                                     float]]:
        """``(key, scale)`` if this group is univariate-horizontal and
        proportional to an existing stage-1 factor on the same source."""
        if any(kn != 0 for _, kn in self.taps):
            return None
        kms = sorted(km for km, _ in self.taps)
        if len(kms) < 2:
            return None
        a = [self.taps[(km, 0)] for km in kms]
        scale = max(a, key=abs)
        key = _factor_key(self.src, "m",
                          list(zip(kms, (c / scale for c in a))))
        if key in keys:
            return key, scale
        return None


def _node_groups(nd: ir.Node) -> List[_Group]:
    groups: Dict[int, _Group] = {}
    for t in nd.terms:
        g = groups.get(t.src)
        if g is None:
            g = groups[t.src] = _Group(node=-1, src=t.src, taps={})
        g.taps[(t.km, t.kn)] = g.taps.get((t.km, t.kn), 0.0) + t.c
    return list(groups.values())


def factorize_rank1(prog: ir.TapProgram) -> ir.TapProgram:
    """Globally-costed rank-1 factorization with shared stage-1 filters.

    Phase 1 collects every factorizable group and tallies, per canonical
    factor key, the MAC delta of factoring all its consumers.  Phase 2
    rewrites the program, materializing only the profitable stage-1
    nodes.  Term order in rewritten lincombs stays source-major with
    sorted taps, keeping the executors deterministic.
    """
    # ---- phase 1: tally savings per candidate factor ---------------------
    savings: Dict[Tuple, int] = {}
    factors: Dict[Tuple, List[Tuple[int, float]]] = {}
    for nd in prog.nodes:
        if nd.kind != "lincomb":
            continue
        for g in _node_groups(nd):
            f = g.factorization()
            if f is None:
                continue
            key, a_taps, b_taps = f
            factors.setdefault(key, a_taps)
            savings[key] = savings.get(key, 0) + \
                len(g.taps) - len(b_taps)
    # univariate groups proportional to a candidate add further savings
    for nd in prog.nodes:
        if nd.kind != "lincomb":
            continue
        for g in _node_groups(nd):
            m = g.scaled_match(factors)
            if m is not None:
                savings[m[0]] = savings.get(m[0], 0) + len(g.taps) - 1
    chosen = {key for key, s in savings.items()
              if s >= len(factors[key])}

    # ---- phase 2: rewrite ------------------------------------------------
    nodes: List[ir.Node] = []
    remap: Dict[int, int] = {}
    stage1: Dict[Tuple, int] = {}

    def _get_stage1(key: Tuple, src_new: int) -> int:
        nid = stage1.get(key)
        if nid is None:
            taps = factors[key]
            terms = tuple(ir.Term(src=src_new, km=km, kn=0, c=c)
                          for km, c in taps)
            nodes.append(ir.Node(kind="lincomb", terms=terms))
            nid = stage1[key] = len(nodes) - 1
        return nid

    for i, nd in enumerate(prog.nodes):
        if nd.kind != "lincomb":
            remap[i] = len(nodes)
            nodes.append(nd)
            continue
        new_terms: List[ir.Term] = []
        seen_srcs: List[int] = []
        for t in nd.terms:
            if t.src not in seen_srcs:
                seen_srcs.append(t.src)
        groups = {g.src: g for g in _node_groups(nd)}
        for src in seen_srcs:
            g = groups[src]
            src_new = remap[src]
            emitted = False
            f = g.factorization()
            if f is not None and f[0] in chosen:
                key, _, b_taps = f
                t1 = _get_stage1(key, src_new)
                for kn, c in b_taps:
                    new_terms.append(ir.Term(src=t1, km=0, kn=kn, c=c))
                emitted = True
            if not emitted:
                m = g.scaled_match({k: 1 for k in chosen})
                if m is not None:
                    key, scale = m
                    t1 = _get_stage1(key, src_new)
                    new_terms.append(ir.Term(src=t1, km=0, kn=0, c=scale))
                    emitted = True
            if not emitted:
                for (km, kn), c in sorted(g.taps.items()):
                    new_terms.append(ir.Term(src=src_new, km=km, kn=kn,
                                             c=c))
        remap[i] = len(nodes)
        nodes.append(ir.Node(kind="lincomb", terms=tuple(new_terms)))
    out = ir.program(nodes, tuple(remap[o] for o in prog.outputs))
    return out


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

OPT_LEVELS = ("off", "exact", "full")


def optimize_program(prog: ir.TapProgram, opt: str = "full"
                     ) -> ir.TapProgram:
    if opt not in OPT_LEVELS:
        raise ValueError(f"unknown opt level {opt!r}; available: "
                         f"{OPT_LEVELS}")
    if opt == "off":
        return prog
    prog = prune_dead_terms(prog)
    if opt == "full":
        prog = factorize_rank1(prog)
        prog = hash_cons(prog)
    return eliminate_dead_nodes(prog)
