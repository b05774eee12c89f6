"""Framework-free parts of the window-kernel path, and its step runner.

The reference package runs every barrier step (or fused step group) of a
scheme as one launch of its Pallas window kernel.  Here the same step
model drives the hand-written CUDA window kernel
(:mod:`repro_torch.kernels.tap_window`):

* :class:`StepSpec` / :func:`steps_of` — a scheme as barrier-delimited
  ``(pre, main, post)`` matrix triples; :func:`scheme_steps` — those of
  a named scheme, memoized;
* :func:`_pick_block` — block edge selection per axis;
* :func:`scheme_hbm_bytes` — the device-memory traffic model of one
  transform level on this kernel; :func:`pyramid_hbm_bytes` — that of
  one fused-pyramid launch (a plan's executor sums them over one
  execution, :mod:`repro_torch.engine.executor`);
* :func:`pyramid_out_levels` — the fused-pyramid kernels' subband order;
* :func:`apply_steps_cuda` — one launch per step (``fuse="none"``, the
  paper's barrier count) or one per level (``fuse="scheme"``), reading a
  level's image and writing it back without a copy around the kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

from repro_torch import telemetry as T
from repro_torch.core import optimize as O
from repro_torch.core import poly as P
from repro_torch.core import schemes as S

#: bytes the plane copies around the window kernel write, per site:
#: ``split`` where what a level hands K1 (its image, or its planes) is
#: not contiguous and is copied so; ``merge`` has no site left, since K1
#: writes an inverse level's image itself
PLANE_COPY_BYTES = T.counter(
    "repro_plane_copy_bytes_total",
    "bytes written by the plane copies around the window kernel",
    labelnames=("op",))
SPLIT_BYTES = PLANE_COPY_BYTES.bind(op="split")
#: levels whose split (K1's first launch read the image) or merge (its
#: last launch wrote the image) the window kernel absorbed, one add a
#: level
PLANE_FOLDS = T.counter(
    "repro_plane_folds_total",
    "levels whose polyphase split or merge the window kernel absorbed",
    labelnames=("op",))
SPLIT_FOLDS = PLANE_FOLDS.bind(op="split")
MERGE_FOLDS = PLANE_FOLDS.bind(op="merge")


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


@functools.lru_cache(maxsize=512)
def scheme_steps(wavelet: str, scheme: str, optimize: bool,
                 inverse: bool) -> Tuple[StepSpec, ...]:
    """Scheme algebra -> StepSpec sequence, memoized across all plans."""
    if inverse:
        return tuple(steps_of(S.build_inverse_scheme(wavelet, scheme)))
    sch = (O.build_optimized(wavelet, scheme) if optimize
           else S.build_scheme(wavelet, scheme))
    return tuple(steps_of(sch))


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
                     itemsize: int, block: Tuple[int, int]) -> int:
    """Modelled device-memory bytes of one transform level on a (H, W)
    image through the window kernel, one entry of ``programs`` per launch.

    Per launch: every block reads its four ``(bh+2r) x (bw+2r)`` windows
    (overlap counted, ragged edge included: the kernel gathers them with
    mod indexing from the unpadded planes) and writes four ``bh x bw``
    blocks, masked to the plane.  The first launch reads the level's
    image and the last writes it back, so no polyphase split or merge
    pass runs outside the kernel.
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
    return total


def _contiguous(ts):
    """``ts`` flattened to ``(B, h, w)`` and contiguous: views where they
    are contiguous already, else one copy each, made inside a
    ``planes.split`` span and counted in :data:`SPLIT_BYTES`."""
    if all(t.is_contiguous() for t in ts):
        return tuple(t.reshape((-1,) + t.shape[-2:]) for t in ts)
    with T.device_span("planes.split", ts[0].device):
        out = tuple(t.reshape((-1,) + t.shape[-2:]).contiguous()
                    for t in ts)
    SPLIT_BYTES.inc(sum(q.numel() * q.element_size()
                        for t, q in zip(ts, out)
                        if q.data_ptr() != t.data_ptr()))
    return out


def apply_steps_cuda(steps: Sequence[StepSpec], x, *,
                     fuse: str = "none", compute_dtype: str = "float32",
                     tap_opt: str = "full",
                     windows: Optional[Tuple] = None,
                     image_out: bool = False):
    """Execute a scheme's steps through the window kernel, on one
    level's image or on its four polyphase planes.

    ``x`` is either the level's image ``(..., H, W)`` (H and W even),
    which the first launch reads as its four polyphase planes (the split
    folded into the kernel's gather), or the four planes
    ``(..., H/2, W/2)``.  Leading batch dims are flattened into the
    kernel's batch grid dimension.  Returns the four output planes or,
    with ``image_out``, the image ``(..., H, W)`` the last launch
    interleaves them into (the merge folded into its sink).  Each level
    whose split or merge the kernel absorbed adds one to
    :data:`PLANE_FOLDS`; an input that is not contiguous is copied first
    (:data:`SPLIT_BYTES`).

    fuse="none"   — paper-faithful: one launch per step; the step count
                    is the paper's barrier count.
    fuse="scheme" — one launch per level (compound halo, overlapped-tile
                    recompute).

    ``tap_opt`` selects the tap-program compilation level; ``"off"`` runs
    the lowered raw walk (bit-identical to walking the matrices).
    Pre-encoded ``windows`` (one
    :class:`~repro_torch.kernels.tap_window.WindowProgram` per launch, as a
    plan holds them) skip compilation and the SMEM guard.  On CPU tensors
    the kernel's plain version runs instead (see
    :func:`~repro_torch.kernels.tap_window.tap_window`).
    """
    import torch
    from repro_torch import compiler as C
    from repro_torch.kernels import tap_window as TW
    steps = tuple(steps)
    if fuse not in ("none", "scheme"):
        raise ValueError(f"unknown fuse mode {fuse!r}")
    image = isinstance(x, torch.Tensor)
    if image:
        if x.dim() < 2 or x.shape[-2] % 2 or x.shape[-1] % 2:
            raise ValueError(f"apply_steps_cuda: image (..., H, W) needs "
                             f"H and W even, got {tuple(x.shape)}")
        batch = x.shape[:-2]
        hp, wp = x.shape[-2] // 2, x.shape[-1] // 2
    else:
        x = tuple(x)
        batch = x[0].shape[:-2]
        hp, wp = x[0].shape[-2:]
    if windows is None:
        groups = [steps] if fuse == "scheme" else [(st,) for st in steps]
        programs = tuple(C.compile_steps(g, tap_opt) for g in groups)
        block = TW.fit_block(programs, hp, wp)
        windows = tuple(TW.encode(p, block, compute_dtype)
                        for p in programs)
    if image:
        cur = _contiguous((x,))[0]
        SPLIT_FOLDS.inc()
    else:
        cur = _contiguous(x)
    for win in windows[:-1]:
        cur = TW.tap_window(win, cur)
    if image_out:
        x = TW.tap_window(windows[-1], cur, image_out=True)
        MERGE_FOLDS.inc()
        return x.reshape(batch + x.shape[-2:])
    cur = TW.tap_window(windows[-1], cur)
    return tuple(p.reshape(batch + p.shape[-2:]) for p in cur)
