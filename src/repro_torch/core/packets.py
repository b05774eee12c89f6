"""Wavelet packet decomposition trees (leaf module — numpy only).

The port's own copy of the reference's tree algebra: the same canonical
encoding, error texts and costs, so both packages choose a tree from the
same numbers.

The 2-D DWT pyramid recurses into the LL (approximation) subband only.
A *wavelet packet* transform may recurse into any of the four children
of a node — LL/HL/LH/HH — giving a quad-tree of subband decompositions.
This module is the tree algebra: canonical encoding, admissibility
validation, and the Coifman–Wickerhauser best-basis pruning over
additive cost functionals.  The transform itself executes through the
plan engine (``PlanKey.packet`` carries the canonical leaf tuple; see
:mod:`repro_torch.engine.plan` and :func:`repro_torch.core.transform.wpt2`).

Encoding
--------
A node is a path string over the child alphabet ``a/h/v/d``
(approximation ``a`` = LL, horizontal ``h`` = HL, vertical ``v`` = LH,
diagonal ``d`` = HH — matching the subband order the level executors
return).  A tree is its set of **leaf** paths, canonically sorted in
quad-tree traversal order; the root is the empty path and is never a
leaf.  A leaf set is *admissible* when it tiles the frequency plane
exactly: prefix-free, and the leaf measures ``4^(depth - len(path))``
sum to ``4^depth``.  Any admissible leaf set reconstructs exactly —
the inverse walks the internal nodes bottom-up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

__all__ = ["CHILDREN", "PacketTree", "COSTS", "cost_shannon", "cost_l1",
           "cost_threshold", "best_basis_from_costs"]

#: child order of one 2-D split, matching the level executors' output
#: (LL, HL, LH, HH)
CHILDREN = ("a", "h", "v", "d")
_ORDER = {c: i for i, c in enumerate(CHILDREN)}


def _path_key(path: str) -> Tuple[int, ...]:
    """Quad-tree traversal sort key (``a < h < v < d`` at every digit)."""
    return tuple(_ORDER[c] for c in path)


PacketSpec = Union["PacketTree", str, Iterable[str]]


@dataclasses.dataclass(frozen=True)
class PacketTree:
    """An admissible packet decomposition, held as its canonical leaf
    tuple.  Construct via :meth:`full`, :meth:`pyramid`,
    :meth:`from_leaves` or :meth:`from_spec`; the constructor itself
    validates, so every held instance is admissible.

    >>> PacketTree.full(1).leaves
    ('a', 'h', 'v', 'd')
    >>> PacketTree.pyramid(2).leaves          # the plain DWT as a tree
    ('aa', 'ah', 'av', 'ad', 'h', 'v', 'd')
    >>> PacketTree.from_spec("full:2").depth
    2
    """

    leaves: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "leaves", _validate(self.leaves))

    # -- constructors --------------------------------------------------

    @classmethod
    def full(cls, depth: int) -> "PacketTree":
        """The complete quad-tree: every node splits down to ``depth``."""
        if depth < 1:
            raise ValueError(f"packet depth must be >= 1, got {depth}")
        paths = [""]
        for _ in range(depth):
            paths = [p + c for p in paths for c in CHILDREN]
        return cls(tuple(paths))

    @classmethod
    def pyramid(cls, levels: int) -> "PacketTree":
        """The plain DWT pyramid as a packet tree (recurse into ``a``
        only) — useful as a best-basis candidate and in tests."""
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        leaves = ["a" * levels]
        for lvl in range(levels):
            leaves.extend("a" * lvl + c for c in CHILDREN[1:])
        return cls(tuple(leaves))

    @classmethod
    def from_leaves(cls, leaves: Iterable[str]) -> "PacketTree":
        return cls(tuple(leaves))

    @classmethod
    def from_spec(cls, spec: PacketSpec) -> "PacketTree":
        """Resolve the user-facing ``packet=`` argument: a PacketTree,
        a ``"full:D"`` / ``"dwt:L"`` string, or an iterable of leaf
        paths."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            kind, sep, arg = spec.partition(":")
            if not sep or not arg.isdigit():
                raise ValueError(
                    f"packet spec string must be 'full:D' or 'dwt:L', "
                    f"got {spec!r}")
            if kind == "full":
                return cls.full(int(arg))
            if kind == "dwt":
                return cls.pyramid(int(arg))
            raise ValueError(f"unknown packet spec kind {kind!r}; "
                             f"available: 'full', 'dwt'")
        return cls.from_leaves(spec)

    # -- structure -------------------------------------------------------

    @property
    def depth(self) -> int:
        """Deepest leaf level == the plan's ``levels``."""
        return max(len(p) for p in self.leaves)

    def internal_nodes(self) -> Tuple[str, ...]:
        """Every node that splits, topologically sorted (parents before
        children) — the forward executor's work list; reverse it for
        the inverse."""
        seen = set()
        for leaf in self.leaves:
            for i in range(len(leaf)):
                seen.add(leaf[:i])
        return tuple(sorted(seen, key=lambda p: (len(p), _path_key(p))))

    def __len__(self) -> int:
        return len(self.leaves)

    def __contains__(self, path: str) -> bool:
        return path in self.leaves


def _validate(leaves: Tuple[str, ...]) -> Tuple[str, ...]:
    if not leaves:
        raise ValueError("packet tree has no leaves")
    for p in leaves:
        if not isinstance(p, str) or not p:
            raise ValueError(
                f"packet leaf paths must be non-empty strings over "
                f"{'/'.join(CHILDREN)}, got {p!r} (the root cannot be a "
                f"leaf: a packet transform decomposes at least once)")
        bad = set(p) - set(CHILDREN)
        if bad:
            raise ValueError(
                f"packet leaf {p!r} uses unknown child label(s) "
                f"{sorted(bad)}; alphabet: {CHILDREN}")
    canon = tuple(sorted(set(leaves), key=lambda p: (_path_key(p), p)))
    if len(canon) != len(leaves):
        raise ValueError(f"duplicate packet leaves in {sorted(leaves)}")
    depth = max(len(p) for p in canon)
    # admissibility = exact frequency-plane tiling: prefix-free + the
    # leaf measures sum to the whole plane
    leafset = set(canon)
    for p in canon:
        for i in range(1, len(p)):
            if p[:i] in leafset:
                raise ValueError(
                    f"inadmissible packet tree: leaf {p[:i]!r} is a "
                    f"prefix of leaf {p!r} (subbands overlap)")
    measure = sum(4 ** (depth - len(p)) for p in canon)
    if measure != 4 ** depth:
        raise ValueError(
            f"inadmissible packet tree: leaves cover {measure}/{4 ** depth} "
            f"of the frequency plane at depth {depth} (must tile exactly; "
            f"every internal node needs all four children accounted for)")
    return canon


# ---------------------------------------------------------------------------
# Best basis: additive cost functionals + Coifman–Wickerhauser pruning
# ---------------------------------------------------------------------------

def cost_shannon(a) -> float:
    """Non-normalized Shannon entropy ``-sum v·log v`` over ``v = a²``
    (the classical Coifman–Wickerhauser functional; additive)."""
    v = np.asarray(a, np.float64).ravel() ** 2
    v = v[v > 0.0]
    return float(-(v * np.log(v)).sum()) if v.size else 0.0


def cost_l1(a) -> float:
    """Sparsity surrogate: sum of absolute coefficient values."""
    return float(np.abs(np.asarray(a, np.float64)).sum())


def cost_threshold(a, threshold: float = 1e-2) -> float:
    """Count of coefficients above ``threshold`` in magnitude."""
    return float((np.abs(np.asarray(a, np.float64)) > threshold).sum())


COSTS = {"shannon": cost_shannon, "l1": cost_l1,
         "threshold": cost_threshold}


def best_basis_from_costs(costs: Dict[str, float], depth: int
                          ) -> PacketTree:
    """Coifman–Wickerhauser bottom-up pruning over per-node costs.

    ``costs`` must hold one additive-cost value for **every** node of
    the full quad-tree to ``depth`` (the empty path = root included).
    A node keeps its children when their best total cost beats its own;
    the root always splits (a packet transform decomposes at least
    once).

    >>> flat = {p: 1.0 for p in ["", "a", "h", "v", "d"]}
    >>> best_basis_from_costs(flat, 1).leaves  # root must split anyway
    ('a', 'h', 'v', 'd')
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    levels: List[List[str]] = [[""]]
    for _ in range(depth):
        levels.append([p + c for p in levels[-1] for c in CHILDREN])
    best: Dict[str, Tuple[float, Tuple[str, ...]]] = {}
    for d in range(depth, -1, -1):
        for path in levels[d]:
            try:
                own = float(costs[path])
            except KeyError:
                raise ValueError(
                    f"best_basis_from_costs: missing cost for node "
                    f"{path!r} (need every node of the full depth-"
                    f"{depth} tree)") from None
            if d == depth:
                best[path] = (own, (path,))
                continue
            kids_cost = sum(best[path + c][0] for c in CHILDREN)
            kids_leaves = sum((best[path + c][1] for c in CHILDREN), ())
            if own <= kids_cost and d > 0:       # keep the node whole
                best[path] = (own, (path,))
            else:                                # split (root always)
                best[path] = (kids_cost, kids_leaves)
    return PacketTree(best[""][1])
