"""State carried across from the reference package, by duck typing.

Nothing here imports the reference package: :func:`tap_program_from_fields`
reads any object with a tap program's fields, and :func:`pyramid_from_numpy`,
:func:`pyramid3_from_numpy` and :func:`packet_from_numpy` take plain arrays,
so one compiled program, 2-D or 3-D pyramid or packet decomposition made by
the reference can be fed to both packages.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.compiler.ir import Node, TapProgram, Term
from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D


def tap_program_from_fields(obj) -> TapProgram:
    """Rebuild a :class:`TapProgram` from an object exposing
    ``nodes[*].kind / .j / .terms[*].(src, km, kn, c)`` and ``outputs``."""
    nodes = tuple(
        Node(kind=str(nd.kind), j=int(nd.j),
             terms=tuple(Term(src=int(t.src), km=int(t.km), kn=int(t.kn),
                              c=float(t.c)) for t in nd.terms))
        for nd in obj.nodes)
    return TapProgram(nodes=nodes, outputs=tuple(int(o) for o in obj.outputs))


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def pyramid_from_numpy(ll, details: Sequence[Sequence], device="cpu"
                       ) -> Pyramid:
    """Build a :class:`Pyramid` from array-likes (coarsest detail triple
    first, as :class:`Pyramid` stores them) on ``device``."""
    return Pyramid(ll=_tensor(ll, device),
                   details=[tuple(_tensor(d, device) for d in det)
                            for det in details])


def pyramid3_from_numpy(ll, details: Sequence[Sequence], device="cpu"
                        ) -> Pyramid3:
    """Build a :class:`Pyramid3` from array-likes: the tLLL volume and one
    7-subband tuple per level, coarsest first, in the order of
    :data:`~repro_torch.engine.pyramid.Detail3`."""
    return Pyramid3(ll=_tensor(ll, device),
                    details=[tuple(_tensor(d, device) for d in det)
                             for det in details])


def packet_from_numpy(paths: Sequence[str], leaves: Sequence,
                      device="cpu") -> WaveletPacket2D:
    """Build a :class:`WaveletPacket2D` from leaf paths and one array-like
    per leaf, in the same (canonical) order."""
    return WaveletPacket2D(paths=tuple(paths),
                           leaves=[_tensor(a, device) for a in leaves])
