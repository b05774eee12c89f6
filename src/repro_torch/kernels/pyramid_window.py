"""The fused-pyramid kernels: the whole L-level 2-D DWT in one launch.

Replace the reference package's Pallas kernels
``kernels/polyphase.py::pyramid_forward_pallas`` (K2) and
``::pyramid_inverse_pallas`` (K3).  The CUDA source is
``repro_torch/csrc/pyramid_window.cu``; this module encodes the per-level
programs for it, computes the exact shared memory of a launch (the guard
of :func:`repro_torch.engine.plan._resolve_pyramid`), launches both
kernels through ``ctypes`` (built and bound like the window kernel,
:class:`~repro_torch.kernels.tap_window.KernelLibrary`) and keeps their
plain versions, :func:`pyramid_forward_ref` and :func:`pyramid_inverse_ref`.

What bounds them on an H100: the unique bytes are two passes over the
image (it is read once, every subband written once, or the reverse); the
work is the window kernel's table walk.

* K2 (forward) is one cooperative launch of persistent blocks that run
  the levels in turn and meet at a grid-wide barrier between them.
  Level ``l`` does the window kernel's work on the four polyphase planes
  of its image (the input, or the LL level ``l-1`` wrote to a scratch
  plane), at the block the per-level path picks for that level
  (:func:`~repro_torch.kernels.tap_window.fit_block`), with only program
  ``l``'s own halo: the same term evaluations as ``fuse="levels"``,
  without its split copies and launch gaps.  The split is folded into
  the gather; LL is stored in the I/O dtype between levels, as the
  per-level path stores it.
* K3 (inverse) runs every level of one image-space block in one block,
  coarsest first, with every intermediate LL plane in shared memory: its
  windows carry the compound margin of the coarser levels.  Level ``l``
  runs program ``l`` with its outputs at margin ``sched.shrinks[l]`` in a
  window of halo ``margins[l+1]`` around the ``(bh >> l+1) x
  (bw >> l+1)`` core (the interleaved outputs are the next finer level's
  LL window; at level 0 exactly the block).

Both walk the window kernel's table format (``csrc/window_common.cuh``),
one table per level.  Per position the arithmetic is the per-level
path's left fold over the same terms, and LL is rounded through the I/O
dtype between levels, so both kernels equal their plain versions (the
per-level chain of :func:`~repro_torch.kernels.tap_window.window_ref`)
bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compiler import ir
from repro_torch.compiler.pyramid import PyramidSchedule
from repro_torch.core import schemes as S
from repro_torch.kernels import tap_window as TW
from repro_torch.kernels.polyphase import pyramid_out_levels

SOURCE = TW.CSRC / "pyramid_window.cu"
#: deepest pyramid the kernels take (their subband pointer table)
MAX_LEVELS = 8

# table layout, shared with csrc/pyramid_window.cu
_PYR_HEADER = 8      # levels, level_ints, n_slots, slot_floats, front, back
_LEVEL_INTS = 4      # offset, then K2: bh, bw, 0; K3: halo, shrink, 0


@dataclasses.dataclass(frozen=True)
class LevelWindow:
    """Where level ``l`` of the inverse kernel works: a ``wh x ww`` plane
    window of halo ``halo`` around the ``core`` block, outputs at margin
    ``shrink``."""

    halo: int
    shrink: int
    core: Tuple[int, int]

    @property
    def window(self) -> Tuple[int, int]:
        return (self.core[0] + 2 * self.halo, self.core[1] + 2 * self.halo)

    @property
    def out_region(self) -> Tuple[int, int]:
        wh, ww = self.window
        return (wh - 2 * self.shrink, ww - 2 * self.shrink)


def level_windows(sched: PyramidSchedule, block: Tuple[int, int]
                  ) -> Tuple[LevelWindow, ...]:
    """The per-level windows of one inverse launch at the image-space
    ``block``, finest level first."""
    if sched.kind != "inverse":
        raise ValueError("level_windows: the forward kernel's windows are "
                         "the window kernel's at each level's block")
    return tuple(LevelWindow(halo=sched.margins[l + 1],
                             shrink=sched.shrinks[l],
                             core=(block[0] >> (l + 1), block[1] >> (l + 1)))
                 for l in range(sched.levels))


def carry_floats(sched: PyramidSchedule, block: Tuple[int, int]) -> int:
    """Floats of the inverse kernel's LL carry: the largest interleaved
    output a finer level reads."""
    regions = [w.out_region for w in level_windows(sched, block)[1:]]
    return max((4 * a * b for a, b in regions), default=0)


def windows_fit(sched: PyramidSchedule, block: Tuple[int, int]) -> bool:
    """True when every inverse level window lies inside the bounds the
    kernels' row mapping is checked for (:func:`~repro_torch.kernels.
    tap_window.check_window`)."""
    return all(w.window[1] <= TW.MAX_WINDOW_WIDTH
               and w.window[0] * w.window[1] <= TW.MAX_WINDOW_ELEMS
               for w in level_windows(sched, block))


def _inverse_sizes(programs, sched, block):
    """Per-level layouts (outputs at the level's shrink) of the inverse
    kernel, its positions per thread (chosen for the largest window, level
    0's) and its shared-memory layout: (layouts, elems, level_ints,
    n_slots, slot_floats, front, back)."""
    lays = [TW.layout(p, s) for p, s in zip(programs, sched.shrinks)]
    wins = level_windows(sched, block)
    elems = TW.choose_elems(lays[0], *wins[0].window)
    pads = [TW.pads(w.halo, w.window[1], elems) for w in wins]
    return (lays, elems, max(TW.table_ints(lay) for lay in lays),
            max(lay.n_slots for lay in lays),
            max(w.window[0] * w.window[1] for w in wins),
            max(f for f, _ in pads), max(b for _, b in pads))


def smem_bytes(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
               block: Tuple[int, int]) -> int:
    """Dynamic shared memory of one inverse launch, exactly as the kernel
    lays it out: the largest level table, the front pad, one input stage
    and ``n_slots`` slots the size of the largest level window, the back
    pad and the LL carry."""
    _, _, level_ints, n_slots, slot, front, back = _inverse_sizes(
        programs, sched, block)
    return 4 * ((level_ints + 3) // 4 * 4 + front + (4 + n_slots) * slot
                + back + carry_floats(sched, block))


def forward_elems(programs: Sequence[ir.TapProgram],
                  blocks: Sequence[Tuple[int, int]]) -> int:
    """Positions per thread of the forward kernel: those level 0 (the
    largest) would pick alone."""
    p, (bh, bw) = programs[0], blocks[0]
    return TW.choose_elems(TW.layout(p), bh + 2 * p.halo, bw + 2 * p.halo)


def forward_smem_bytes(programs: Sequence[ir.TapProgram],
                       blocks: Sequence[Tuple[int, int]]) -> int:
    """Dynamic shared memory of one forward launch: the largest window
    kernel footprint of its levels (each at its own block)."""
    elems = forward_elems(programs, blocks)
    return max(TW.smem_bytes(p, b, elems) for p, b in zip(programs, blocks))


@dataclasses.dataclass(eq=False)
class PyramidWindow:
    """One fused-pyramid kernel (forward or inverse), encoded.

    ``table`` is the int32 pyramid table the kernel walks; it is uploaded
    once per device (:meth:`device_table`) and reused by every launch.
    ``level_blocks`` are the plane-space blocks of each level: the
    forward kernel's tiles, the inverse kernel's cores.  ``block`` is the
    image-space block: the inverse kernel's, twice the forward kernel's
    level-0 tile.
    """

    kind: str                               # "forward" | "inverse"
    programs: Tuple[ir.TapProgram, ...]     # one per level, finest first
    sched: PyramidSchedule
    block: Tuple[int, int]
    level_blocks: Tuple[Tuple[int, int], ...]
    compute_dtype: str
    table: np.ndarray
    smem_bytes: int
    elems: int                              # walk positions per thread
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def levels(self) -> int:
        return self.sched.levels

    def level_tiles(self, shape: Tuple[int, int, int]) -> Tuple[int, ...]:
        """Forward: tiles of each level over a ``(B, H, W)`` image."""
        nb, h, w = shape
        return tuple(nb * -(-(h >> (l + 1)) // bh) * -(-(w >> (l + 1)) // bw)
                     for l, (bh, bw) in enumerate(self.level_blocks))

    def term_evaluations(self, shape: Tuple[int, int, int]) -> int:
        """Term evaluations of one launch over a ``(B, H, W)`` image, all
        levels (the inverse's window recompute included)."""
        if self.kind == "forward":
            return sum(
                n * TW.walk_terms(p, TW.layout(p), bh + 2 * p.halo,
                                  bw + 2 * p.halo)
                for n, p, (bh, bw) in zip(self.level_tiles(shape),
                                          self.programs, self.level_blocks))
        nb, h, w = shape
        blocks = nb * -(-h // self.block[0]) * -(-w // self.block[1])
        return blocks * sum(
            TW.walk_terms(p, TW.layout(p, lw.shrink), *lw.window)
            for p, lw in zip(self.programs,
                             level_windows(self.sched, self.block)))

    def device_table(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            t = self._tables.get(device)
            if t is None:
                t = torch.tensor(self.table, device=device)
                self._tables[device] = t
            return t


def _check_encode(programs, levels: int, compute_dtype: str) -> None:
    if compute_dtype not in TW.COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"available: {tuple(TW.COMPUTE_DTYPES)}")
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels {levels} outside 1..{MAX_LEVELS}")
    if len(programs) != levels:
        raise ValueError(f"need {levels} per-level programs, got "
                         f"{len(programs)}")


def _pyramid_table(header, levels, tables) -> np.ndarray:
    offset = _PYR_HEADER + _LEVEL_INTS * len(tables)
    rows = []
    for lv, t in zip(levels, tables):
        rows += [offset] + list(lv)
        offset += len(t)
    table = np.concatenate([np.array(header + rows, np.int32), *tables])
    table.setflags(write=False)
    return table


def encode_forward(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
                   blocks: Sequence[Tuple[int, int]],
                   compute_dtype: str = "float32") -> PyramidWindow:
    """Encode the forward kernel: level ``l`` walks ``programs[l]`` at the
    plane-space ``blocks[l]`` with its own halo (see the table layout in
    ``csrc/pyramid_window.cu``)."""
    programs = tuple(programs)
    blocks = tuple((int(b[0]), int(b[1])) for b in blocks)
    _check_encode(programs, sched.levels, compute_dtype)
    if len(blocks) != len(programs):
        raise ValueError(f"need {len(programs)} level blocks, got "
                         f"{len(blocks)}")
    elems = forward_elems(programs, blocks)
    tables = []
    for prog, (bh, bw) in zip(programs, blocks):
        r = prog.halo
        tables.append(TW.table_rows(prog, TW.layout(prog), bh + 2 * r,
                                    bw + 2 * r, r, compute_dtype, elems))
    header = [sched.levels, max(len(t) for t in tables), 0, 0, 0, 0, 0, 0]
    return PyramidWindow(
        kind="forward", programs=programs, sched=sched,
        block=(2 * blocks[0][0], 2 * blocks[0][1]), level_blocks=blocks,
        compute_dtype=compute_dtype,
        table=_pyramid_table(header, [(bh, bw, 0) for bh, bw in blocks],
                             tables),
        smem_bytes=forward_smem_bytes(programs, blocks), elems=elems)


def encode_inverse(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
                   block: Tuple[int, int],
                   compute_dtype: str = "float32") -> PyramidWindow:
    """Encode the inverse kernel for launches at the image-space
    ``block`` (see the table layout in ``csrc/pyramid_window.cu``)."""
    programs = tuple(programs)
    L = sched.levels
    _check_encode(programs, L, compute_dtype)
    if any(int(e) <= 0 or int(e) % (1 << L) for e in block):
        raise ValueError(f"block {tuple(block)} must be positive multiples "
                         f"of 2^levels = {1 << L}")
    lays, elems, level_ints, n_slots, slot, front, back = _inverse_sizes(
        programs, sched, block)
    wins = level_windows(sched, block)
    tables = [TW.table_rows(prog, lay, *w.window, w.halo, compute_dtype,
                            elems)
              for prog, lay, w in zip(programs, lays, wins)]
    header = [L, level_ints, n_slots, slot, front, back, 0, 0]
    return PyramidWindow(
        kind="inverse", programs=programs, sched=sched,
        block=(int(block[0]), int(block[1])),
        level_blocks=tuple(w.core for w in wins),
        compute_dtype=compute_dtype,
        table=_pyramid_table(header, [(w.halo, w.shrink, 0) for w in wins],
                             tables),
        smem_bytes=smem_bytes(programs, sched, block), elems=elems)


# ---------------------------------------------------------------------------
# Build and bind (first launch on a CUDA tensor)
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pyramid_forward_launch.argtypes = [p, p, p, i, p, i] + [i] * 9 \
        + [p, p]
    lib.pyramid_forward_launch.restype = i
    lib.pyramid_inverse_launch.argtypes = [p, p, i, p] + [i] * 10 + [p, p]
    lib.pyramid_inverse_launch.restype = i


LIBRARY = TW.KernelLibrary(SOURCE, _bind)
FORWARD = TW.Kernel("pyramid_forward", LIBRARY)
INVERSE = TW.Kernel("pyramid_inverse", LIBRARY)


# ---------------------------------------------------------------------------
# Wrappers and plain versions
# ---------------------------------------------------------------------------

def _subband_shapes(pw: PyramidWindow, batch: int, h: int, w: int):
    return [(batch, h >> (l + 1), w >> (l + 1))
            for l in pyramid_out_levels(pw.levels)]


def _check_io(pw: PyramidWindow, kind: str, tensors, shapes) -> None:
    if pw.kind != kind:
        raise ValueError(f"{pw.kind} pyramid table passed to the {kind} "
                         f"kernel")
    t0 = tensors[0]
    if t0.dtype not in TW.IO_CODES:
        raise TypeError(f"pyramid_{kind} I/O dtype {t0.dtype} unsupported; "
                        f"supported: {tuple(TW.IO_CODES)}")
    got = [tuple(t.shape) for t in tensors]
    if got != [tuple(s) for s in shapes]:
        raise ValueError(f"pyramid_{kind} takes {shapes}, got {got}")
    for t in tensors[1:]:
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"pyramid_{kind} inputs disagree: {t.dtype} "
                             f"{t.device} vs {t0.dtype} {t0.device}")


def _check_forward(pw: PyramidWindow, x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"pyramid_forward takes a (B, H, W) image, got "
                         f"{tuple(x.shape)}")
    nb, h, w = x.shape
    div = 1 << pw.levels
    if h % div or w % div:
        raise ValueError(f"pyramid_forward: image {h}x{w} not divisible "
                         f"by 2^levels = {div}")
    _check_io(pw, "forward", [x], [(nb, h, w)])


def _check_inverse(pw: PyramidWindow, subbands) -> Tuple[int, int, int]:
    ll = subbands[0]
    if ll.dim() != 3:
        raise ValueError(f"pyramid_inverse takes (B, h, w) subbands, got "
                         f"{tuple(ll.shape)}")
    nb = ll.shape[0]
    h, w = ll.shape[1] << pw.levels, ll.shape[2] << pw.levels
    _check_io(pw, "inverse", subbands, _subband_shapes(pw, nb, h, w))
    return nb, h, w


def _grid_ok(what: str, pw: PyramidWindow, nb: int, h: int, w: int) -> None:
    gy, gx = -(-h // pw.block[0]), -(-w // pw.block[1])
    if nb > 65535 or gy > 65535:
        raise ValueError(f"{what} grid ({gx}, {gy}, {nb}) exceeds the "
                         f"launch limits")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def scratch_planes(pw: PyramidWindow, x: torch.Tensor):
    """The forward kernel's scratch: the LL plane of every level but the
    last, in the I/O dtype, from one allocation (``torch.empty``)."""
    nb, h, w = x.shape
    sizes = [nb * (h >> (l + 1)) * (w >> (l + 1))
             for l in range(pw.levels - 1)]
    if not sizes:
        return []
    buf = torch.empty(sum(sizes), dtype=x.dtype, device=x.device)
    return [t.view(nb, h >> (l + 1), w >> (l + 1))
            for l, t in enumerate(buf.split(sizes))]


def pyramid_forward_ref(pw: PyramidWindow, x: torch.Tensor):
    """Plain version of K2: the per-level chain — split, the level's
    program through :func:`~repro_torch.kernels.tap_window.window_ref`,
    LL stored in the I/O dtype and split again.  Returns ``(ll,
    details)`` with details finest-first."""
    _check_forward(pw, x)
    cur, details = x, []
    for prog in pw.programs:
        ys = TW.window_ref(prog, S.to_planes(cur), pw.compute_dtype)
        details.append(tuple(ys[1:]))
        cur = ys[0]
    return cur, tuple(details)


def pyramid_inverse_ref(pw: PyramidWindow, ll: torch.Tensor, details):
    """Plain version of K3: the per-level chain from the coarsest level —
    the level's program through
    :func:`~repro_torch.kernels.tap_window.window_ref` on ``[LL, HL, LH,
    HH]``, interleaved, stored in the I/O dtype.  ``details`` is
    finest-first."""
    _check_inverse(pw, [ll] + [d for det in details for d in det])
    cur = ll
    for l in range(pw.levels - 1, -1, -1):
        ys = TW.window_ref(pw.programs[l], (cur, *details[l]),
                           pw.compute_dtype)
        cur = S.from_planes(ys)
    return cur


def pyramid_forward(pw: PyramidWindow, x: torch.Tensor):
    """Whole forward pyramid of a ``(B, H, W)`` image in one launch:
    ``(ll, details)`` with details finest-first.

    CUDA tensors launch K2 (and count one launch) or raise; CPU tensors
    run :func:`pyramid_forward_ref`.
    """
    _check_forward(pw, x)
    dev = x.device
    if dev.type == "cpu":
        return pyramid_forward_ref(pw, x)
    if dev.type != "cuda":
        raise ValueError(f"pyramid_forward runs on cuda or cpu tensors, "
                         f"got {dev}")
    if not x.is_contiguous():
        raise ValueError("pyramid_forward image must be contiguous")
    nb, h, w = x.shape
    tiles = pw.level_tiles((nb, h, w))
    if max(tiles) >= 2 ** 31:
        raise ValueError(f"pyramid_forward: {max(tiles)} tiles exceed the "
                         f"kernel's int32 tile index")
    lib = FORWARD.library()
    outs = [torch.empty(s, dtype=x.dtype, device=dev)
            for s in _subband_shapes(pw, nb, h, w)]
    scratch = scratch_planes(pw, x)
    table = pw.device_table(dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = lib.pyramid_forward_launch(
            table.data_ptr(), x.data_ptr(), _pointers(outs), len(outs),
            _pointers(scratch), len(scratch), nb, h, w, max(tiles),
            pw.smem_bytes, pw.elems, TW.IO_CODES[x.dtype],
            int(pw.compute_dtype == "bfloat16"), dev.index, _stream(dev),
            info)
    LIBRARY.check(err, "pyramid_forward")
    FORWARD.launched(info)
    details = tuple(tuple(outs[1 + 3 * l:4 + 3 * l])
                    for l in range(pw.levels))
    return outs[0], details


def pyramid_inverse(pw: PyramidWindow, ll: torch.Tensor, details
                    ) -> torch.Tensor:
    """Whole inverse pyramid in one launch: ``ll`` ``(B, H>>L, W>>L)`` and
    ``details`` finest-first to the ``(B, H, W)`` image.

    CUDA tensors launch K3 (and count one launch) or raise; CPU tensors
    run :func:`pyramid_inverse_ref`.
    """
    subbands = [ll] + [d for det in details for d in det]
    nb, h, w = _check_inverse(pw, subbands)
    dev = ll.device
    if dev.type == "cpu":
        return pyramid_inverse_ref(pw, ll, details)
    if dev.type != "cuda":
        raise ValueError(f"pyramid_inverse runs on cuda or cpu tensors, "
                         f"got {dev}")
    if not all(t.is_contiguous() for t in subbands):
        raise ValueError("pyramid_inverse subbands must be contiguous")
    _grid_ok("pyramid_inverse", pw, nb, h, w)
    lib = INVERSE.library()
    out = torch.empty((nb, h, w), dtype=ll.dtype, device=dev)
    table = pw.device_table(dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = lib.pyramid_inverse_launch(
            table.data_ptr(), _pointers(subbands), len(subbands),
            out.data_ptr(), nb, h, w, pw.block[0], pw.block[1],
            pw.smem_bytes, pw.elems, TW.IO_CODES[ll.dtype],
            int(pw.compute_dtype == "bfloat16"), dev.index, _stream(dev),
            info)
    LIBRARY.check(err, "pyramid_inverse")
    INVERSE.launched(info)
    return out

