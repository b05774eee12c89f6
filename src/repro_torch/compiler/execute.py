"""Tap-program executors over torch tensors.

Two interpretations of the same program:

* :func:`run_window` — the window form: every shift is a static slice of
  an already-gathered window that carries ``out_margin`` extra samples on
  each side.  A backward margin analysis (:func:`required_margins`)
  assigns each node the exact region its consumers need, so factored
  stage-1 filters are computed once over (block + residual halo).  This
  is the plain version of the CUDA window kernel
  (``repro_torch.kernels.tap_window``), which walks the same regions.

* :func:`run_planes` — the torch reference form: shifts are periodic
  ``torch.roll``s over whole (batched) planes.

Both walk terms in program order with left-fold accumulation and the same
strength reductions (``c == 1.0`` skips the multiply, ``c == -1.0``
negates), so for identical inputs they produce identical values — and the
lowered (pass-free) program reproduces the raw matrix walk bit for bit.
Coefficients are rounded to the compute dtype before they multiply
(:func:`repro_torch.core.schemes.coef`), as the window kernel does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.compiler import ir
from repro_torch.core.schemes import coef


def required_margins(prog: ir.TapProgram, out_margin: int
                     ) -> List[Optional[Tuple[int, int]]]:
    """Backward pass: the ``(gm, gn)`` margin each node is computed at so
    the outputs land exactly at ``out_margin``.  ``None`` = never read."""
    if out_margin < prog.halo:
        raise ValueError(
            f"window halo {out_margin} < program halo {prog.halo}")
    fwd = prog.margins()
    req: List[Optional[Tuple[int, int]]] = [None] * len(prog.nodes)
    for o in prog.outputs:
        req[o] = (out_margin, out_margin)
    for i in range(len(prog.nodes) - 1, -1, -1):
        r = req[i]
        if r is None:
            continue
        assert r[0] >= fwd[i][0] and r[1] >= fwd[i][1], \
            f"node {i}: margin {r} infeasible (needs {fwd[i]})"
        for t in prog.nodes[i].terms:
            cand = (r[0] - abs(t.km), r[1] - abs(t.kn))
            prev = req[t.src]
            req[t.src] = cand if prev is None else (min(prev[0], cand[0]),
                                                    min(prev[1], cand[1]))
    return req


def _mac(acc, arr, c: float):
    """One strength-reduced multiply-accumulate (exact for unit coeffs)."""
    v = arr if c == 1.0 else (-arr if c == -1.0 else arr * coef(c, arr.dtype))
    return v if acc is None else acc + v


def run_window(prog: ir.TapProgram, xs: Sequence[torch.Tensor],
               out_margin: int) -> List[torch.Tensor]:
    """Execute over four equally-shaped ``(..., H, W)`` windows; outputs
    shrink by ``2*out_margin`` per axis."""
    H, W = xs[0].shape[-2:]
    req = required_margins(prog, out_margin)
    vals: List[Optional[torch.Tensor]] = [None] * len(prog.nodes)
    margins: List[Tuple[int, int]] = [(0, 0)] * len(prog.nodes)
    for i, nd in enumerate(prog.nodes):
        if nd.kind == "input":
            vals[i] = xs[nd.j]
            continue
        r = req[i]
        if r is None:
            continue  # dead node (kept only for numbering)
        qm, qn = r
        oh, ow = H - 2 * qn, W - 2 * qm
        acc = None
        for t in nd.terms:
            sm, sn = margins[t.src]
            r0 = (qn - t.kn) - sn
            c0 = (qm - t.km) - sm
            acc = _mac(acc, vals[t.src][..., r0:r0 + oh, c0:c0 + ow], t.c)
        vals[i] = acc if acc is not None else xs[0].new_zeros(
            xs[0].shape[:-2] + (oh, ow))
        margins[i] = (qm, qn)
    return [vals[o] for o in prog.outputs]


def _shift(x: torch.Tensor, km: int, kn: int) -> torch.Tensor:
    """Periodic shift: ``y[.., n, m] = x[.., n - kn, m - km]``."""
    if kn:
        x = torch.roll(x, kn, dims=-2)
    if km:
        x = torch.roll(x, km, dims=-1)
    return x


def run_planes(prog: ir.TapProgram, planes: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Execute over full (..., H, W) planes with periodic boundary."""
    vals: List[Optional[torch.Tensor]] = [None] * len(prog.nodes)
    for i, nd in enumerate(prog.nodes):
        if nd.kind == "input":
            vals[i] = planes[nd.j]
            continue
        acc = None
        for t in nd.terms:
            src = vals[t.src]
            if src is None:
                continue  # source of a dead subgraph
            acc = _mac(acc, _shift(src, t.km, t.kn), t.c)
        vals[i] = acc if acc is not None \
            else (torch.zeros_like(planes[0]) if nd.terms == () else None)
    outs = []
    for o in prog.outputs:
        outs.append(vals[o] if vals[o] is not None
                    else torch.zeros_like(planes[0]))
    return outs
