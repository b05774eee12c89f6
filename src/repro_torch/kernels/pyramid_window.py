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

Both kernels are one cooperative launch of persistent blocks that run
the levels in turn and meet at a grid-wide barrier between them.  Level
``l`` does the window kernel's work on four ``(B, H>>l+1, W>>l+1)``
planes, at the block the per-level path picks for that level
(:func:`~repro_torch.kernels.tap_window.fit_block` of the level's two
programs) and with only program ``l``'s own halo: the same term
evaluations as ``fuse="levels"``, without its launch gaps.  The LL between levels goes through a scratch plane in the
I/O dtype, as the per-level path stores it.

* K2 (forward), finest level first: the four planes are the polyphase
  split of the level's image (the input, or the LL level ``l-1`` wrote),
  folded into the gather.
* K3 (inverse), coarsest level first: the four planes are the LL (the
  coarsest LL input, or the image level ``l+1`` wrote) and the level's
  HL, LH, HH; the sink interleaves the four outputs into the level's
  image (the next level's LL, or the output).

Both walk the window kernel's table format (``csrc/window_common.cuh``),
one table per level: K1's table of the level's program at its block.
Per position the arithmetic is the per-level path's left fold over the
same terms, and LL is rounded through the I/O dtype between levels, so
both kernels equal their plain versions (the per-level chain of
:func:`~repro_torch.kernels.tap_window.window_ref`) bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Sequence, Tuple

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
_PYR_HEADER = 8      # levels, the largest level table's ints, 0 x 6
_LEVEL_INTS = 4      # offset, bh, bw, 0


def level_elems(programs: Sequence[ir.TapProgram],
                blocks: Sequence[Tuple[int, int]]) -> int:
    """Positions per thread of a pyramid kernel's walk: those level 0 (the
    largest) would pick alone."""
    p, (bh, bw) = programs[0], blocks[0]
    return TW.choose_elems(TW.layout(p), bh + 2 * p.halo, bw + 2 * p.halo)


def smem_bytes(programs: Sequence[ir.TapProgram],
               blocks: Sequence[Tuple[int, int]]) -> int:
    """Dynamic shared memory of one pyramid launch: the largest window
    kernel footprint of its levels (each at its own block)."""
    elems = level_elems(programs, blocks)
    return max(TW.smem_bytes(p, b, elems) for p, b in zip(programs, blocks))


@dataclasses.dataclass(eq=False)
class PyramidWindow:
    """One fused-pyramid kernel (forward or inverse), encoded.

    ``table`` is the int32 pyramid table the kernel walks; it is uploaded
    once per device (:meth:`device_table`) and reused by every launch.
    ``level_blocks`` are the plane-space tiles of each level; ``block`` is
    the image-space block of level 0, twice its tile.
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
        """Tiles of each level over a ``(B, H, W)`` image."""
        nb, h, w = shape
        return tuple(nb * -(-(h >> (l + 1)) // bh) * -(-(w >> (l + 1)) // bw)
                     for l, (bh, bw) in enumerate(self.level_blocks))

    def term_evaluations(self, shape: Tuple[int, int, int]) -> int:
        """Term evaluations of one launch over a ``(B, H, W)`` image, all
        levels."""
        return sum(
            n * TW.walk_terms(p, TW.layout(p), bh + 2 * p.halo,
                              bw + 2 * p.halo)
            for n, p, (bh, bw) in zip(self.level_tiles(shape), self.programs,
                                      self.level_blocks))

    def device_table(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            t = self._tables.get(device)
            if t is None:
                t = torch.tensor(self.table, device=device)
                self._tables[device] = t
            return t


def _encode(kind: str, programs: Sequence[ir.TapProgram],
            sched: PyramidSchedule, blocks: Sequence[Tuple[int, int]],
            compute_dtype: str) -> PyramidWindow:
    """Level ``l`` walks K1's table of ``programs[l]`` at the plane-space
    ``blocks[l]`` with its own halo (see the table layout in
    ``csrc/pyramid_window.cu``)."""
    programs = tuple(programs)
    blocks = tuple((int(b[0]), int(b[1])) for b in blocks)
    if compute_dtype not in TW.COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"available: {tuple(TW.COMPUTE_DTYPES)}")
    if sched.kind != kind:
        raise ValueError(f"{sched.kind} schedule passed to the {kind} "
                         f"encoder")
    if not 1 <= sched.levels <= MAX_LEVELS:
        raise ValueError(f"levels {sched.levels} outside 1..{MAX_LEVELS}")
    if len(programs) != sched.levels:
        raise ValueError(f"need {sched.levels} per-level programs, got "
                         f"{len(programs)}")
    if len(blocks) != len(programs):
        raise ValueError(f"need {len(programs)} level blocks, got "
                         f"{len(blocks)}")
    elems = level_elems(programs, blocks)
    tables = []
    for prog, (bh, bw) in zip(programs, blocks):
        r = prog.halo
        tables.append(TW.table_rows(prog, TW.layout(prog), bh + 2 * r,
                                    bw + 2 * r, r, compute_dtype, elems))
    offset = _PYR_HEADER + _LEVEL_INTS * len(tables)
    rows = [sched.levels, max(len(t) for t in tables)] + [0] * 6
    for (bh, bw), t in zip(blocks, tables):
        rows += [offset, bh, bw, 0]
        offset += len(t)
    table = np.concatenate([np.array(rows, np.int32), *tables])
    table.setflags(write=False)
    return PyramidWindow(
        kind=kind, programs=programs, sched=sched,
        block=(2 * blocks[0][0], 2 * blocks[0][1]), level_blocks=blocks,
        compute_dtype=compute_dtype, table=table,
        smem_bytes=smem_bytes(programs, blocks), elems=elems)


def encode_forward(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
                   blocks: Sequence[Tuple[int, int]],
                   compute_dtype: str = "float32") -> PyramidWindow:
    """Encode the forward kernel K2 at the per-level plane ``blocks``."""
    return _encode("forward", programs, sched, blocks, compute_dtype)


def encode_inverse(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
                   blocks: Sequence[Tuple[int, int]],
                   compute_dtype: str = "float32") -> PyramidWindow:
    """Encode the inverse kernel K3 at the per-level plane ``blocks``."""
    return _encode("inverse", programs, sched, blocks, compute_dtype)


# ---------------------------------------------------------------------------
# Build and bind (first launch on a CUDA tensor)
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pyramid_forward_launch, lib.pyramid_inverse_launch):
        fn.argtypes = [p, p, p, i, p, i] + [i] * 9 + [p, p]
        fn.restype = i


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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def scratch_planes(pw: PyramidWindow, image: torch.Tensor):
    """The kernels' scratch for a ``(B, H, W)`` image: the LL plane of
    every level but the coarsest, in the I/O dtype, from one allocation
    (``torch.empty``).  K2 writes level ``l``'s LL to plane ``l``; K3
    writes level ``l``'s image to plane ``l-1``."""
    nb, h, w = image.shape
    sizes = [nb * (h >> (l + 1)) * (w >> (l + 1))
             for l in range(pw.levels - 1)]
    if not sizes:
        return []
    buf = torch.empty(sum(sizes), dtype=image.dtype, device=image.device)
    return [t.view(nb, h >> (l + 1), w >> (l + 1))
            for l, t in enumerate(buf.split(sizes))]


def _launch(kernel: TW.Kernel, pw: PyramidWindow, image: torch.Tensor,
            subbands) -> None:
    """One launch of K2 (``image`` in, ``subbands`` out) or K3 (the
    reverse); counts it, or raises."""
    nb, h, w = image.shape
    tiles = max(pw.level_tiles((nb, h, w)))
    if tiles >= 2 ** 31:
        raise ValueError(f"{kernel.name}: {tiles} tiles exceed the "
                         f"kernel's int32 tile index")
    launch = getattr(kernel.library(), f"{kernel.name}_launch")
    dev = image.device
    scratch = scratch_planes(pw, image)
    table = pw.device_table(dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        err = launch(
            table.data_ptr(), image.data_ptr(), _pointers(subbands),
            len(subbands), _pointers(scratch), len(scratch), nb, h, w, tiles,
            pw.smem_bytes, pw.elems, TW.IO_CODES[image.dtype],
            int(pw.compute_dtype == "bfloat16"), dev.index, _stream(dev),
            info)
    LIBRARY.check(err, kernel.name)
    kernel.launched(info)


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
    outs = [torch.empty(s, dtype=x.dtype, device=dev)
            for s in _subband_shapes(pw, nb, h, w)]
    _launch(FORWARD, pw, x, outs)
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
    out = torch.empty((nb, h, w), dtype=ll.dtype, device=dev)
    _launch(INVERSE, pw, out, subbands)
    return out
