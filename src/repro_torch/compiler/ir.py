"""Tap-program IR: the compile-time form of a polyphase step sequence.

A :class:`TapProgram` is a flat SSA list of nodes computing the four
output polyphase planes from the four input planes.  Node kinds:

* ``input``   — one of the four polyphase planes (``j`` in 0..3);
* ``lincomb`` — an ordered linear combination ``sum_t c_t * z^{-k_t} v_t``
  of shifted, scaled reads of earlier nodes.  The term order is part of
  the program semantics: executors accumulate left-to-right, so two
  programs with the same terms in the same order produce bit-identical
  floating-point results.

Everything a matrix walk can express lowers to this form (a 4x4 matrix
application is four ``lincomb`` nodes), and so do the optimizer's
factored forms (a 1-D filter pass is a ``lincomb`` whose terms share one
source and shift along one axis).  The per-pixel arithmetic cost of a
program is therefore directly countable (:meth:`TapProgram.stats`), which
is what the benchmarks report as MACs/pixel.

Shift convention matches :mod:`repro_torch.core.poly`: a term ``(km, kn, c)``
reads ``src[n - kn, m - km]`` (``m`` = columns, ``n`` = rows).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

UNIT_TOL = 0.0  # unit coefficients must be exact to be strength-reduced


@dataclasses.dataclass(frozen=True)
class Term:
    """One addend of a lincomb: ``c * shift(nodes[src], (km, kn))``."""

    src: int
    km: int
    kn: int
    c: float


@dataclasses.dataclass(frozen=True)
class Node:
    """One SSA value.  ``kind`` is "input" (plane ``j``) or "lincomb"."""

    kind: str
    j: int = -1
    terms: Tuple[Term, ...] = ()

    def max_shift(self) -> Tuple[int, int]:
        """(max |km|, max |kn|) over this node's own terms."""
        if not self.terms:
            return (0, 0)
        return (max(abs(t.km) for t in self.terms),
                max(abs(t.kn) for t in self.terms))


@dataclasses.dataclass(frozen=True)
class TapProgram:
    """Nodes in dependency order + the four output node ids."""

    nodes: Tuple[Node, ...]
    outputs: Tuple[int, int, int, int]

    def __post_init__(self):
        for i, nd in enumerate(self.nodes):
            for t in nd.terms:
                if not 0 <= t.src < i:
                    raise ValueError(
                        f"node {i}: term reads {t.src}, not an earlier node")
        for o in self.outputs:
            if not 0 <= o < len(self.nodes):
                raise ValueError(f"output id {o} out of range")

    # -- geometry ----------------------------------------------------------

    def margins(self) -> List[Tuple[int, int]]:
        """Forward per-axis margins ``(gm, gn)``: how far inside the loaded
        window each node's value is computable (inputs: 0)."""
        g: List[Tuple[int, int]] = []
        for nd in self.nodes:
            if nd.kind == "input" or not nd.terms:
                g.append((0, 0))
                continue
            gm = max(g[t.src][0] + abs(t.km) for t in nd.terms)
            gn = max(g[t.src][1] + abs(t.kn) for t in nd.terms)
            g.append((gm, gn))
        return g

    @property
    def halo(self) -> int:
        """Window pad radius required to produce the outputs: the maximum
        per-axis margin over the four outputs.  Per-axis accumulation means
        this can be *smaller* than the sum of per-step matrix halos (e.g.
        alternating horizontal/vertical lifting steps)."""
        g = self.margins()
        return max(max(g[o]) for o in self.outputs)

    # -- cost model --------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Arithmetic cost of one program application, per quad (one output
        sample in each of the four planes = a 2x2 input pixel block).

        ``macs`` follows the paper's Table 1 convention: every term is one
        multiply-accumulate, except that per lincomb one exact-unit
        (c == 1.0) term is free — it seeds the accumulator, exactly like
        the "units on the diagonal" the paper excludes.  ``muls``/``adds``
        count the scalar ops the executors actually emit (unit and
        negated-unit coefficients skip the multiply).
        """
        macs = muls = adds = terms = 0
        for nd in self.nodes:
            if nd.kind != "lincomb" or not nd.terms:
                continue
            n = len(nd.terms)
            terms += n
            macs += n - (1 if any(t.c == 1.0 for t in nd.terms) else 0)
            muls += sum(1 for t in nd.terms if t.c not in (1.0, -1.0))
            adds += n - 1
        return {"nodes": len(self.nodes), "terms": terms, "macs": macs,
                "muls": muls, "adds": adds, "halo": self.halo}

    @property
    def macs(self) -> int:
        return self.stats()["macs"]

    def macs_per_pixel(self) -> float:
        """MACs per *image* pixel (plane samples cover 1/4 of the image)."""
        return self.macs / 4.0


def program(nodes: Sequence[Node], outputs: Sequence[int]) -> TapProgram:
    return TapProgram(nodes=tuple(nodes), outputs=tuple(outputs))
