"""Framework-free parts of the window-kernel path, and its step runner.

The reference package runs every barrier step (or fused step group) of a
scheme as one launch of its Pallas window kernel.  Here the same step
model drives the hand-written CUDA window kernel
(:mod:`repro_torch.kernels.tap_window`):

* :class:`StepSpec` / :func:`steps_of` — a scheme as barrier-delimited
  ``(pre, main, post)`` matrix triples;
* :func:`_pick_block` — block edge selection per axis;
* :func:`scheme_hbm_bytes` — the device-memory traffic model of one
  transform level on this kernel; :func:`pyramid_hbm_bytes` — that of
  one fused-pyramid launch; :func:`plan_hbm_bytes` — that of one
  execution of a plan (what the live roofline and the chip script
  divide by);
* :func:`pyramid_out_levels` — the fused-pyramid kernels' subband order;
* :func:`apply_steps_cuda` — one launch per step (``fuse="none"``, the
  paper's barrier count) or one per level (``fuse="scheme"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core import optimize as O
from repro_torch.core import poly as P


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Matrices of one barrier-delimited step (hashable, static)."""

    pre: Tuple[P.Matrix, ...]
    main: Optional[P.Matrix]
    post: Tuple[P.Matrix, ...]

    @property
    def halo(self) -> int:
        return P.matrix_halo(self.main) if self.main is not None else 0


def steps_of(scheme_obj) -> List[StepSpec]:
    """Normalize a Scheme / OptScheme into a list of StepSpecs."""
    if isinstance(scheme_obj, O.OptScheme):
        return [StepSpec(tuple(st.pre), st.main, tuple(st.post))
                for st in scheme_obj.steps]
    return [StepSpec((), m, ()) for m, _ in scheme_obj.steps]


def _pick_block(n: int, target: int) -> Tuple[int, int]:
    """Block edge and covered plane size for one axis: ``(b, n_covered)``.

    Prefer an exact divisor of ``n`` close to the target (no ragged
    edge); when only tiny divisors exist (prime / non-smooth plane dims)
    keep the target-size block and cover the plane with a ragged last
    block.  The window kernel reads with mod-``n`` indexing and masks the
    ragged edge on its store, so nothing is padded in memory.
    """
    b = min(n, target)
    d = b
    while n % d:
        d -= 1
    if 2 * d >= b:
        return d, n
    return b, -(-n // b) * b


def pyramid_out_levels(levels: int) -> List[int]:
    """Fused-pyramid I/O layout: the level of each subband slot, in
    order — coarsest LL first, then (HL, LH, HH) per level finest-first.
    Shared by the forward/inverse kernels and their plain versions."""
    return [levels - 1] + [l for l in range(levels) for _ in range(3)]


class PyramidBytes(NamedTuple):
    """Device-memory bytes of one fused-pyramid launch."""

    modelled: int    # what the kernel moves: window overlap counted
    unique: int      # image read (or written) once, every subband once


def pyramid_hbm_bytes(shape: Tuple[int, int], itemsize: int,
                      blocks: Sequence[Tuple[int, int]],
                      halos: Sequence[int]) -> PyramidBytes:
    """Modelled device-memory bytes of one fused-pyramid launch on a
    (H, W) image, either direction: ``blocks`` are the plane-space tiles
    of each level, ``halos`` each level program's halo.

    The port's kernels pad nothing: every window is gathered with mod
    indexing from the unpadded image, subbands or LL scratch, the tiles
    cover each axis with a ragged last tile, and every store is masked
    to the true dims.  Level ``l`` reads the four ``(bh+2r) x (bw+2r)``
    windows of every tile, overlap counted, and writes its four outputs
    once: the forward its HL/LH/HH and its LL (to the scratch or, at the
    last level, the LL output), the inverse the level's interleaved image
    (to the scratch or, at level 0, the output).  So each intermediate LL
    is written once and read once (with its halo overlap).
    """
    h, w = shape
    total = 0
    for l, ((bh, bw), r) in enumerate(zip(blocks, halos)):
        hp, wp = h >> (l + 1), w >> (l + 1)
        tiles = -(-hp // bh) * -(-wp // bw)
        total += 4 * tiles * (bh + 2 * r) * (bw + 2 * r) + 4 * hp * wp
    return PyramidBytes(modelled=total * itemsize,
                        unique=2 * h * w * itemsize)


def scheme_hbm_bytes(programs: Sequence, shape: Tuple[int, int],
                     itemsize: int, block: Tuple[int, int],
                     split_merge: bool = True) -> int:
    """Modelled device-memory bytes of one transform level on a (H, W)
    image through the window kernel, one entry of ``programs`` per launch.

    Per launch: every block reads its four ``(bh+2r) x (bw+2r)`` windows
    (overlap counted, ragged edge included: the kernel gathers them with
    mod indexing from the unpadded planes) and writes four ``bh x bw``
    blocks, masked to the plane.  ``split_merge`` counts the polyphase
    deinterleave (forward) / reinterleave (inverse) that runs outside the
    kernel: one extra read + write of the full image per level.
    """
    h, w = shape
    hp, wp = h // 2, w // 2
    bh, hp2 = _pick_block(hp, block[0])
    bw, wp2 = _pick_block(wp, block[1])
    total = 0
    for prog in programs:
        r = prog.halo
        read = 4 * (hp2 // bh) * (wp2 // bw) * (bh + 2 * r) * (bw + 2 * r)
        write = 4 * hp * wp
        total += (read + write) * itemsize
    if split_merge:
        total += 2 * h * w * itemsize
    return total


def plan_hbm_bytes(plan, op: str = "forward") -> int:
    """Modelled device-memory bytes of one ``op`` execution
    (``"forward"`` or ``"inverse"``) of a plan, batch included.

    * ``"cuda"`` with a fused-pyramid spec: :func:`pyramid_hbm_bytes`
      (modelled) of the direction's kernel, per image;
    * ``"cuda"`` per level: :func:`scheme_hbm_bytes` of each level's
      launches, once per run of the level (``plan.level_runs``: a packet
      node, a temporal half-band); a 3-D level adds its temporal pass,
      which reads the level's volume once and writes its two half-bands
      once;
    * ``"torch"`` and ``"conv"``: the unique bytes, input read once and
      every output written once (``2 x numel x itemsize``) — the port
      has no traffic model of its own for the roll and ``F.conv2d``
      paths;
    * a tiled plan (``plan.grid`` set): :func:`tiled_hbm_bytes`.
    """
    import torch  # the I/O dtype's size; the module stays framework-free
    key = plan.key
    itemsize = getattr(torch, key.dtype).itemsize
    numel = math.prod(key.shape)
    if plan.grid is not None:
        return tiled_hbm_bytes(plan, op, itemsize)
    if key.backend != "cuda":
        return 2 * numel * itemsize
    inverse = op == "inverse"
    h, w = key.shape[-2:]
    if plan.pyramid is not None:
        pw = plan.pyramid.inv_kernel if inverse else plan.pyramid.fwd_kernel
        per_image = pyramid_hbm_bytes((h, w), itemsize, pw.level_blocks,
                                      [p.halo for p in pw.programs])
        return per_image.modelled * (numel // (h * w))
    total = 0
    for spec, runs, images in zip(plan.level_specs, plan.level_runs,
                                  plan.level_images):
        programs = spec.inv_programs if inverse else spec.fwd_programs
        hl, wl = spec.image_shape
        if key.ndim == 3:
            # the temporal pass: the level's volume (both half-bands'
            # frames) read once, the two half-bands written once
            total += 2 * (2 * images) * hl * wl * itemsize
        total += runs * images * scheme_hbm_bytes(programs, (hl, wl),
                                                  itemsize, spec.block)
    return total


def tiled_hbm_bytes(plan, op: str, itemsize: int) -> int:
    """Modelled device-memory bytes of one ``op`` execution of a tiled
    plan: its window plan's modelled bytes (:func:`plan_hbm_bytes` of the
    stacked windows), plus the halo gather — the image (forward) or the
    pyramid's planes (inverse) read once, every window written once —
    plus the stitch — every tile's core read once, the pyramid's planes
    (forward) or the image (inverse) written once.  A pyramid holds as
    many samples as its image, and the cores of a grid as many as the
    grid covers (``T x th x tw``, overhang included)."""
    from repro_torch.tiling import api as TA  # deferred: tiling -> engine
    key, grid = plan.key, plan.grid
    h, w = key.shape[-2:]
    lead = math.prod(key.shape[:-2])
    (th, tw), tiles = grid.tile, grid.count
    image = lead * h * w
    cores = lead * tiles * th * tw
    if op == "inverse":
        mi, L = grid.inv_margin, key.levels
        sizes = [(th >> (l + 1)) + 2 * (mi >> (l + 1)) for l in range(L)]
        sizes_w = [(tw >> (l + 1)) + 2 * (mi >> (l + 1)) for l in range(L)]
        per_tile = (sum(3 * a * b for a, b in zip(sizes, sizes_w))
                    + sizes[-1] * sizes_w[-1])
    else:
        wh, ww = grid.window_shape
        per_tile = wh * ww
    windows = lead * tiles * per_tile
    window_bytes = plan_hbm_bytes(TA.window_plan(plan, op), op)
    return window_bytes + (image + windows + cores + image) * itemsize


def apply_steps_cuda(steps: Sequence[StepSpec], planes, *,
                     fuse: str = "none", compute_dtype: str = "float32",
                     tap_opt: str = "full",
                     windows: Optional[Tuple] = None):
    """Execute a scheme's steps on the four polyphase planes through the
    window kernel.

    ``planes`` may carry arbitrary leading batch dims ``(..., hp, wp)``;
    they are flattened into the kernel's batch grid dimension.

    fuse="none"   — paper-faithful: one launch per step; the step count
                    is the paper's barrier count.
    fuse="scheme" — one launch per level (compound halo, overlapped-tile
                    recompute).

    ``tap_opt`` selects the tap-program compilation level; ``"off"`` runs
    the lowered raw walk (bit-identical to walking the matrices).
    Pre-encoded ``windows`` (one
    :class:`~repro_torch.kernels.tap_window.WindowProgram` per launch, as a
    plan holds them) skip compilation and the SMEM guard.  On CPU tensors the kernel's plain version
    runs instead (see :func:`~repro_torch.kernels.tap_window.tap_window`).
    """
    from repro_torch import compiler as C
    from repro_torch.kernels import tap_window as TW
    steps = tuple(steps)
    if fuse not in ("none", "scheme"):
        raise ValueError(f"unknown fuse mode {fuse!r}")
    planes = tuple(planes)
    hp, wp = planes[0].shape[-2:]
    if windows is None:
        groups = [steps] if fuse == "scheme" else [(st,) for st in steps]
        programs = tuple(C.compile_steps(g, tap_opt) for g in groups)
        block = TW.fit_block(programs, hp, wp)
        windows = tuple(TW.encode(p, block, compute_dtype)
                        for p in programs)
    batch = planes[0].shape[:-2]
    p3 = [p.reshape((-1,) + p.shape[-2:]).contiguous() for p in planes]
    for win in windows:
        p3 = TW.tap_window(win, p3)
    return tuple(p.reshape(batch + p.shape[-2:]) for p in p3)
