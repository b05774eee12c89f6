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
image (it is read once, every subband written once, or the reverse), but
the work is the table walk of K1 over windows that carry the compound
margin of every level, so the level-0 arithmetic is several times that
of the per-level path.  What the design does: every intermediate LL
plane stays in shared memory (no split, merge or LL round trip through
device memory between levels), windows are gathered with mod indexing
from the unpadded image or subbands, and the ragged edge is masked.

Each level ``l`` runs program ``l`` as the window kernel runs a program
(the same table format and walk, ``csrc/window_common.cuh``), except
that its regions come from :func:`~repro_torch.compiler.execute.
required_margins` at ``sched.shrinks[l]``, not at the program halo:

* forward, level ``l``: a window of halo ``margins[l] / 2`` plane samples
  around the ``(bh >> l+1) x (bw >> l+1)`` core, outputs at margin
  ``shrinks[l]`` (the LL output region is the next level's image window);
* inverse, level ``l``: a window of halo ``margins[l+1]`` around the same
  core, outputs at margin ``shrinks[l]`` (interleaved, the next finer
  level's LL window; at level 0 exactly the block).

Per position the arithmetic is the per-level path's left fold over the
same terms, and LL is rounded through the I/O dtype between levels as
the per-level path stores it, so both kernels equal their plain versions
(the per-level chain of :func:`~repro_torch.kernels.tap_window.window_ref`)
bit for bit.
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
_PYR_HEADER = 4      # levels, level_ints, n_slots, slot_floats
_LEVEL_INTS = 4      # offset, halo, shrink, unused


@dataclasses.dataclass(frozen=True)
class LevelWindow:
    """Where level ``l`` of one fused-pyramid kernel works: a ``wh x ww``
    plane window of halo ``halo`` around the ``core`` block, outputs at
    margin ``shrink``."""

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
    """The per-level windows of one launch at the image-space ``block``,
    finest level first (both directions)."""
    L = sched.levels
    out = []
    for l in range(L):
        halo = (sched.margins[l] // 2 if sched.kind == "forward"
                else sched.margins[l + 1])
        out.append(LevelWindow(halo=halo, shrink=sched.shrinks[l],
                               core=(block[0] >> (l + 1),
                                     block[1] >> (l + 1))))
    return tuple(out)


def carry_floats(sched: PyramidSchedule, block: Tuple[int, int]) -> int:
    """Floats of the LL carry: forward, the largest LL output region a
    later level splits; inverse, the largest interleaved output a finer
    level reads."""
    wins = level_windows(sched, block)
    if sched.kind == "forward":
        regions = [w.out_region for w in wins[:-1]]
        return max((a * b for a, b in regions), default=0)
    regions = [w.out_region for w in wins[1:]]
    return max((4 * a * b for a, b in regions), default=0)


def windows_fit(sched: PyramidSchedule, block: Tuple[int, int]) -> bool:
    """True when every level window lies inside the bounds the kernels'
    row mapping is checked for (:func:`~repro_torch.kernels.tap_window.
    check_window`)."""
    return all(w.window[1] <= TW.MAX_WINDOW_WIDTH
               and w.window[0] * w.window[1] <= TW.MAX_WINDOW_ELEMS
               for w in level_windows(sched, block))


def _sizes(programs, sched, block):
    """Per-level layouts (outputs at the level's shrink), and the shared
    memory they need: (layouts, level_ints, n_slots, slot_floats)."""
    lays = [TW.layout(p, s) for p, s in zip(programs, sched.shrinks)]
    slot = max(w.window[0] * w.window[1] for w in level_windows(sched, block))
    return (lays, max(TW.table_ints(lay) for lay in lays),
            max(lay.n_slots for lay in lays), slot)


def smem_bytes(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
               block: Tuple[int, int]) -> int:
    """Dynamic shared memory of one launch, exactly as the kernel lays it
    out: one level's table, ``n_slots`` fp32 slots the size of the
    largest level window, and the LL carry."""
    _, level_ints, n_slots, slot = _sizes(programs, sched, block)
    return 4 * ((level_ints + 3) // 4 * 4 + n_slots * slot
                + carry_floats(sched, block))


@dataclasses.dataclass(eq=False)
class PyramidWindow:
    """One fused-pyramid kernel (forward or inverse) encoded at one
    image-space block.

    ``table`` is the int32 pyramid table the kernel walks; it is uploaded
    once per device (:meth:`device_table`) and reused by every launch.
    """

    kind: str                               # "forward" | "inverse"
    programs: Tuple[ir.TapProgram, ...]     # one per level, finest first
    sched: PyramidSchedule
    block: Tuple[int, int]                  # image-space (bh, bw)
    compute_dtype: str
    table: np.ndarray
    smem_bytes: int
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def levels(self) -> int:
        return self.sched.levels

    def term_evaluations(self, shape: Tuple[int, int, int]) -> int:
        """Term evaluations of one launch over a ``(B, H, W)`` image, all
        levels (the window recompute included)."""
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


def encode_pyramid(programs: Sequence[ir.TapProgram], sched: PyramidSchedule,
                   block: Tuple[int, int],
                   compute_dtype: str = "float32") -> PyramidWindow:
    """Encode one fused-pyramid kernel (the direction of ``sched``) for
    launches at the image-space ``block`` (see the table layout in
    ``csrc/pyramid_window.cu``)."""
    programs = tuple(programs)
    L = sched.levels
    if compute_dtype not in TW.COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"available: {tuple(TW.COMPUTE_DTYPES)}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"levels {L} outside 1..{MAX_LEVELS}")
    if len(programs) != L:
        raise ValueError(f"need {L} per-level programs, got {len(programs)}")
    if any(int(e) <= 0 or int(e) % (1 << L) for e in block):
        raise ValueError(f"block {tuple(block)} must be positive multiples "
                         f"of 2^levels = {1 << L}")
    lays, level_ints, n_slots, slot = _sizes(programs, sched, block)
    wins = level_windows(sched, block)
    for prog, lay in zip(programs, lays):
        kinds = [prog.nodes[i].kind for i in lay.order]
        # the kernels reuse the LL carry once a level's inputs are loaded,
        # so every input must come before the first lincomb node, and no
        # output may be an input node
        if "input" in kinds[kinds.index("lincomb"):] or any(
                prog.nodes[o].kind == "input" for o in prog.outputs):
            raise ValueError("fused-pyramid programs must load every input "
                             "before computing, and output no input as is")
    tables = [TW.table_rows(prog, lay, *w.window, w.halo, compute_dtype)
              for prog, lay, w in zip(programs, lays, wins)]
    header = [L, level_ints, n_slots, slot]
    offset = _PYR_HEADER + _LEVEL_INTS * L
    levels = []
    for w, t in zip(wins, tables):
        levels += [offset, w.halo, w.shrink, 0]
        offset += len(t)      # a multiple of 4: terms stay 16-byte aligned
    table = np.concatenate([np.array(header + levels, np.int32), *tables])
    table.setflags(write=False)
    return PyramidWindow(kind=sched.kind, programs=programs, sched=sched,
                         block=(int(block[0]), int(block[1])),
                         compute_dtype=compute_dtype, table=table,
                         smem_bytes=smem_bytes(programs, sched, block))


# ---------------------------------------------------------------------------
# Build and bind (first launch on a CUDA tensor)
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pyramid_forward_launch.argtypes = [p, p, p] + [i] * 10 + [p]
    lib.pyramid_forward_launch.restype = i
    lib.pyramid_inverse_launch.argtypes = [p, p, i, p] + [i] * 9 + [p]
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
    _grid_ok("pyramid_forward", pw, nb, h, w)
    lib = FORWARD.library()
    outs = [torch.empty(s, dtype=x.dtype, device=dev)
            for s in _subband_shapes(pw, nb, h, w)]
    table = pw.device_table(dev)
    with torch.cuda.device(dev):
        err = lib.pyramid_forward_launch(
            table.data_ptr(), x.data_ptr(), _pointers(outs), len(outs), nb,
            h, w, pw.block[0], pw.block[1], pw.smem_bytes,
            TW.IO_CODES[x.dtype], int(pw.compute_dtype == "bfloat16"),
            dev.index, _stream(dev))
    LIBRARY.check(err, "pyramid_forward")
    FORWARD.launches += 1
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
    with torch.cuda.device(dev):
        err = lib.pyramid_inverse_launch(
            table.data_ptr(), _pointers(subbands), len(subbands),
            out.data_ptr(), nb, h, w, pw.block[0], pw.block[1],
            pw.smem_bytes, TW.IO_CODES[ll.dtype],
            int(pw.compute_dtype == "bfloat16"), dev.index, _stream(dev))
    LIBRARY.check(err, "pyramid_inverse")
    INVERSE.launches += 1
    return out

