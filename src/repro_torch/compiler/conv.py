"""Conv lowering: a tap program composed into one 4-in / 4-out filter bank.

Every node of a :class:`~repro_torch.compiler.ir.TapProgram` is a linear
function of the four input polyphase planes, so the whole program is one
linear map with finite support:

    out_o[n, m] = sum_j sum_{(km, kn)}  W[o, j, kn, km] * in_j[n-kn, m-km]

i.e. a single bank of 2-D FIR filters (:class:`ConvSpec`), applied as one
convolution over the four planes stacked on the channel axis.  Composition
is done in float64 (NumPy) so the taps are accurate to ~1 ulp of float32.

The port does not execute this: the reference's ``"xla"`` backend, which
runs it, is not ported yet.  ``chip_smoke.py`` times one ``F.conv2d`` of
this bank as the library yardstick beside the window kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.compiler import ir


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """A composed filter bank: one grouped convolution.

    ``weights`` is ``(4, 4, KH, KW)`` float64 in OIHW layout (output
    plane, input plane, row tap, column tap); ``pad = (rn, rm)`` is the
    periodic pad radius per axis, with the zero shift sitting at kernel
    index ``(rn, rm)`` so ``KH = 2*rn + 1`` and ``KW = 2*rm + 1``.
    """

    weights: np.ndarray
    pad: Tuple[int, int]

    @property
    def taps(self) -> int:
        """Nonzero taps = MACs per output quad of the grouped conv."""
        return int(np.count_nonzero(self.weights))


@functools.lru_cache(maxsize=512)
def lower_program_to_conv(prog: ir.TapProgram) -> ConvSpec:
    """Compose a tap program into a single 4x4 bank of 2-D filters.

    Walks the SSA nodes in order, carrying for each node its closed-form
    taps ``{(j, km, kn): c}`` over the *input* planes; a lincomb node's
    taps are the shift-composed, coefficient-scaled union of its terms'
    source taps.  Exact zeros produced by cancellation are dropped.
    """
    taps: List[Dict[Tuple[int, int, int], float]] = []
    for nd in prog.nodes:
        if nd.kind == "input":
            taps.append({(nd.j, 0, 0): 1.0})
            continue
        acc: Dict[Tuple[int, int, int], float] = {}
        for t in nd.terms:
            for (j, km, kn), c in taps[t.src].items():
                k = (j, t.km + km, t.kn + kn)
                acc[k] = acc.get(k, 0.0) + t.c * c
        taps.append({k: c for k, c in acc.items() if c != 0.0})
    outs = [taps[o] for o in prog.outputs]
    rm = max((abs(km) for tp in outs for (_, km, _) in tp), default=0)
    rn = max((abs(kn) for tp in outs for (_, _, kn) in tp), default=0)
    w = np.zeros((4, 4, 2 * rn + 1, 2 * rm + 1), np.float64)
    for o, tp in enumerate(outs):
        for (j, km, kn), c in tp.items():
            w[o, j, rn - kn, rm - km] = c
    w.setflags(write=False)
    return ConvSpec(weights=w, pad=(rn, rm))
