"""Per-level margin/program stacking for the fused-pyramid kernel.

The fused-pyramid kernels (:mod:`repro_torch.kernels.pyramid_window`)
run the whole multi-level transform on one shared-memory window of the
*interleaved* image.  Each forward level splits the current window into
its four polyphase planes at stride 2, runs the level's tap
program, and keeps the (shrunken) LL window as the next level's input —
so the window geometry has to be planned so that

1. every level's program has enough margin left to compute its outputs
   (``shrink_l >= reach_l``), and
2. every in-window polyphase split is *phase-aligned* with the
   monolithic transform: the global image coordinate of window sample
   (0, 0) must be even at every level that still splits.

Let ``o_l`` be the global level-``l`` origin of the window.  The window
start is ``2^L``-aligned (block starts and the compound margin both
are), so ``o_0 = 0 (mod 2^L)``; each level maps ``o_{l+1} = o_l/2 +
s_l`` where ``s_l`` is that level's shrink.  Requiring ``o_l`` even for
all ``l < L`` works out to ``s_l = 0 (mod 2^(L-1-l))`` — the finest
level's shrink needs the strongest alignment.  Rounding each reach up
to that multiple makes the compound margin

    M = sum_l 2^(l+1) * s_l        (automatically a multiple of 2^L)

and the per-level *remaining* margins ``m_l = 2^(L-l) * sum_{i>=l} k_i``
(with ``s_l = k_l * 2^(L-1-l)``) all even — so plane margins and core
offsets stay integral at every level with zero wasted slack
(``m_L = 0``).

The inverse walks coarsest-to-finest and never splits (it interleaves),
so there is no phase constraint — only integrality: ``g_{l+1} =
g_l/2 + s_l`` with ``g_l`` kept even by rounding the shrink up when
needed.  ``g_{l+1}`` is both the margin of the level-``l`` detail
windows and of the reconstructed level-``(l+1)`` LL window.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PyramidSchedule:
    """Static window-margin plan of one fused-pyramid kernel.

    ``reaches[l]`` is what level ``l``'s program actually needs,
    ``shrinks[l]`` the (alignment-rounded) margin consumed at level
    ``l``.  For the forward direction ``margins[l]`` is the remaining
    window margin entering level ``l`` in level-``l`` image pixels
    (``margins[0]`` = the compound window halo, ``margins[L]`` = slack
    around the coarsest LL core); for the inverse, ``margins[l]`` is
    ``g_l`` — the margin of the level-``l`` image window, so the
    level-``l`` subband windows are gathered with margin ``margins[l+1]``
    and ``margins[levels]`` is the coarsest-LL window halo.
    """

    kind: str                    # "forward" | "inverse"
    levels: int
    reaches: Tuple[int, ...]     # per-level program reach (plane samples)
    shrinks: Tuple[int, ...]     # aligned out_margin per level
    margins: Tuple[int, ...]     # length levels + 1, see docstring

    @property
    def halo(self) -> int:
        """The compound margin of the widest window (image pixels
        for forward, coarsest-plane samples for inverse)."""
        return self.margins[0] if self.kind == "forward" \
            else self.margins[-1]


def forward_schedule(reaches: Sequence[int], levels: int) -> PyramidSchedule:
    """Margin plan for one forward fused-pyramid kernel."""
    if len(reaches) != levels:
        raise ValueError(f"need {levels} per-level reaches, got {reaches}")
    ks = []
    shrinks = []
    for l, r in enumerate(reaches):
        align = 1 << (levels - 1 - l)
        k = -(-int(r) // align)
        ks.append(k)
        shrinks.append(k * align)
    margins = tuple((1 << (levels - l)) * sum(ks[l:])
                    for l in range(levels + 1))
    return PyramidSchedule(kind="forward", levels=levels,
                           reaches=tuple(int(r) for r in reaches),
                           shrinks=tuple(shrinks), margins=margins)


def inverse_schedule(reaches: Sequence[int], levels: int) -> PyramidSchedule:
    """Margin plan for one inverse fused-pyramid kernel.

    Built finest-out: ``g_0 = 0`` (the reconstructed block needs no
    margin) and ``g_{l+1} = g_l/2 + shrink_l``, rounding ``g_{l+1}`` up
    to even while a yet-coarser level will halve it again.
    """
    if len(reaches) != levels:
        raise ValueError(f"need {levels} per-level reaches, got {reaches}")
    g = [0]
    shrinks = []
    for l in range(levels):
        nxt = g[l] // 2 + int(reaches[l])
        if l + 1 < levels and nxt % 2:
            nxt += 1
        shrinks.append(nxt - g[l] // 2)
        g.append(nxt)
    return PyramidSchedule(kind="inverse", levels=levels,
                           reaches=tuple(int(r) for r in reaches),
                           shrinks=tuple(shrinks), margins=tuple(g))


@functools.lru_cache(maxsize=512)
def compile_pyramid_programs(wavelet: str, scheme: str, optimize: bool,
                             inverse: bool, opt: str, levels: int):
    """Per-level whole-chain programs for one fused-pyramid kernel.

    Every pyramid level runs the same step chain, so this stacks the
    single whole-chain program ``levels`` times; the tuple shape keeps
    the kernel generic over future per-level program specialization.
    Returns ``None`` when ``opt == "off"`` (the kernel then walks the
    raw matrices level by level).
    """
    if opt == "off":
        return None
    from repro_torch import compiler as C  # deferred: package import order
    prog = C.compile_scheme_programs(wavelet, scheme, optimize, inverse,
                                     opt, "scheme")[0]
    return (prog,) * levels


def level_reaches(steps, programs, levels: int) -> Tuple[int, ...]:
    """Per-level reach: the compiled per-axis margin when programs are
    available, else the summed raw matrix halos (``tap_opt="off"`` —
    the exact shrink of the raw ``_apply_steps_windows`` walk).

    ``programs`` may be a per-level stack (one whole-chain program per
    level), a single whole-chain program (broadcast to every level), or
    a per-step sequence (``fuse="none"`` compilation — the per-call
    reaches add, one re-pad per launch)."""
    if programs is not None:
        hs = [p.halo for p in programs]
        if len(hs) == levels:
            return tuple(hs)
        if len(hs) == 1:
            return (hs[0],) * levels
        return (sum(hs),) * levels
    raw = sum(st.halo for st in steps)
    return (raw,) * levels
