"""State carried across from the reference package, by duck typing.

Nothing here imports the reference package: :func:`tap_program_from_fields`
reads any object with a tap program's fields, and :func:`pyramid_from_numpy`
takes plain arrays, so one compiled program or one pyramid made by the
reference can be fed to both packages.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.compiler.ir import Node, TapProgram, Term
from repro_torch.engine.pyramid import Pyramid


def tap_program_from_fields(obj) -> TapProgram:
    """Rebuild a :class:`TapProgram` from an object exposing
    ``nodes[*].kind / .j / .terms[*].(src, km, kn, c)`` and ``outputs``."""
    nodes = tuple(
        Node(kind=str(nd.kind), j=int(nd.j),
             terms=tuple(Term(src=int(t.src), km=int(t.km), kn=int(t.kn),
                              c=float(t.c)) for t in nd.terms))
        for nd in obj.nodes)
    return TapProgram(nodes=nodes, outputs=tuple(int(o) for o in obj.outputs))


def pyramid_from_numpy(ll, details: Sequence[Sequence], device="cpu"
                       ) -> Pyramid:
    """Build a :class:`Pyramid` from array-likes (coarsest detail triple
    first, as :class:`Pyramid` stores them) on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)
    return Pyramid(ll=t(ll), details=[tuple(t(d) for d in det)
                                      for det in details])
