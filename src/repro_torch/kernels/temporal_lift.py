"""The temporal lifting kernel: one level of the 3-D transform's 1-D
lifting pass along T in one launch per direction.

Replaces no kernel of the reference package: the reference runs this pass
as ``jnp`` between its Pallas kernels
(:mod:`repro_torch.compiler.temporal` is its port), which XLA fuses on
the TPU.  As one ``torch.roll``, multiply and add per tap it moved about
15 times the bytes the pass needs.  The CUDA source is
``repro_torch/csrc/temporal_lift.cu``; this module encodes a
:class:`~repro_torch.compiler.temporal.TemporalProgram` for it, builds it
with ``nvcc`` at first use (:class:`~repro_torch.kernels.tap_window.
KernelLibrary`), launches it through ``ctypes`` and keeps its plain
version, :func:`repro_torch.compiler.temporal.temporal_forward` /
``temporal_inverse``.

What bounds it on an H100: device-memory bytes.  A level reads every
sample once and writes it once, with a few flops per sample.  What the
design does about it (details in the source):

* a thread owns one column of the contiguous ``(H, W)`` plane and a block
  128 neighbouring columns, so every frame a warp touches is one
  contiguous run;
* a block takes one chunk of the ``T/2`` frame pairs (an even split, at
  least :data:`CHUNK` pairs and four times the program's summed reach, so
  the halo over-read stays at or below 12.5%), stages its even and odd
  frames with their halo in column-private shared memory, runs every step
  there with no barrier, and writes only its own pairs;
* the periodic wrap is mod-``T/2`` indexing, right for any even T;
* each side is a base pointer and two strides: the forward reads the
  interleaved volume in place and writes the two half-bands, the inverse
  reads the half-bands and writes the interleaved volume, so neither the
  polyphase split nor the interleave is a copy of its own.

Arithmetic follows the plain version step by step: taps in the program's
order (sorted by ``k``), each product and sum rounded on its own with
``__fmul_rn`` / ``__fadd_rn`` (no contraction), each coefficient rounded
as :func:`~repro_torch.compiler.execute.coef` rounds it; the forward
scales after its steps, the inverse before.  Float32 results equal the
plain version's bit for bit; ``compute_dtype=torch.bfloat16`` rounds every
product and sum to bfloat16, as the plain version's bfloat16 tensors do.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.compiler import temporal as TP
from repro_torch.compiler.execute import coef
from repro_torch.kernels import tap_window as TW

SOURCE = TW.CSRC / "temporal_lift.cu"
#: columns per block (the source's kThreads)
THREADS = 128
#: the table's limits (the source's layout): steps with taps, taps a step
MAX_STEPS, MAX_TAPS = 8, 4
_HEADER, _STEP_INTS = 8, 4 + 2 * MAX_TAPS
#: frame pairs a chunk holds at least; the chunk is also at least four
#: times the program's summed reach (halo over-read <= 12.5%)
CHUNK = 32
#: the grid's limit on the chunks along T (gridDim.y)
MAX_CHUNKS = 65535
IO_CODES = TW.IO_CODES
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
#: scale modes of the table header
_NO_SCALE, _SCALE_AFTER, _SCALE_BEFORE = 0, 1, 2


# ---------------------------------------------------------------------------
# Program encoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reach:
    """The halo of one program, in frame pairs beyond a chunk's own
    ``[0, L)``: each step's evaluated region (``before``, ``after``) and
    what each band must be staged with."""

    steps: Tuple[Tuple[int, int], ...]   # per step with taps
    s: Tuple[int, int]                   # (before, after) staged of s
    d: Tuple[int, int]

    @property
    def total(self) -> int:
        """Halo frames a chunk stages besides its own pairs (both
        bands)."""
        return sum(self.s) + sum(self.d)


def reach(prog: TP.TemporalProgram) -> Reach:
    """Walk the steps backwards from the chunk's own pairs: a step
    updates its target over the region the later steps need of it, and
    so needs its source over that region widened by its tap offsets
    (``other[n - k]``: offset ``-k``)."""
    need = {"s": (0, 0), "d": (0, 0)}
    regions = []
    for st in reversed(prog.steps):
        if not st.taps:
            continue
        src = "s" if st.target == "d" else "d"
        before, after = need[st.target]
        regions.append((before, after))
        offs = [-k for k, _ in st.taps]
        need[src] = (max(need[src][0], before - min(offs)),
                     max(need[src][1], after + max(offs)))
    return Reach(steps=tuple(reversed(regions)), s=need["s"], d=need["d"])


def _bits(c: float, compute_dtype: torch.dtype) -> int:
    return int(np.array(coef(c, compute_dtype), np.float32).view(np.int32))


def table_rows(prog: TP.TemporalProgram,
               compute_dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The program's table (see csrc/temporal_lift.cu):

    * header (8 ints): steps, s staged before / after the chunk, d staged
      before / after, scale mode (0 none, 1 after the steps, 2 before),
      the s and d scales' float32 bits;
    * one record per step with taps (12 ints): target (0 s, 1 d), the
      region it updates before / after the chunk, taps, then per tap the
      offset ``-k`` of the source it reads and the coefficient's bits
      (rounded to ``compute_dtype``), in the program's order, padded
      with zeros to :data:`MAX_TAPS`.
    """
    _check_compute(compute_dtype)
    steps = [st for st in prog.steps if st.taps]
    if len(steps) > MAX_STEPS or any(len(st.taps) > MAX_TAPS
                                     for st in steps):
        raise ValueError(
            f"temporal program {prog.wavelet!r} has {len(steps)} steps of "
            f"up to {max((len(st.taps) for st in steps), default=0)} taps; "
            f"the kernel takes {MAX_STEPS} steps of {MAX_TAPS} taps")
    r = reach(prog)
    if prog.s_scale == 1.0:             # as the plain version's _scale
        mode = _NO_SCALE
    else:
        mode = _SCALE_BEFORE if prog.inverse else _SCALE_AFTER
    rows = [len(steps), *r.s, *r.d, mode,
            _bits(prog.s_scale, compute_dtype),
            _bits(prog.d_scale, compute_dtype)]
    for st, (before, after) in zip(steps, r.steps):
        taps = [v for k, c in st.taps for v in (-k, _bits(c, compute_dtype))]
        rows += [int(st.target == "d"), before, after, len(st.taps), *taps,
                 *[0] * (2 * (MAX_TAPS - len(st.taps)))]
    return np.array(rows, np.int32)


@dataclasses.dataclass(eq=False)
class LiftTable:
    """One program encoded for the kernel; ``table`` is uploaded once per
    device (:meth:`device_table`) and reused by every launch."""

    program: TP.TemporalProgram
    compute_dtype: torch.dtype
    reach: Reach
    table: np.ndarray
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def chunking(self, pairs: int, chunk: Optional[int] = None
                 ) -> Tuple[int, int]:
        """``(chunks, frames)`` of a launch over ``pairs`` frame pairs:
        the even split of the pairs into chunks of at least ``chunk``
        (default the larger of :data:`CHUNK` and four times the summed
        reach; the tests pass smaller ones), and the shared-memory floats
        a thread needs for the longest chunk's two bands with their
        halo."""
        target = chunk or max(CHUNK, 4 * self.reach.total)
        chunks = min(max(1, pairs // int(target)), MAX_CHUNKS)
        frames = 2 * -(-pairs // chunks) + self.reach.total
        if frames * THREADS * 4 > TW.SMEM_LIMIT:
            raise ValueError(
                f"temporal_lift: chunks of {-(-pairs // chunks)} pairs need "
                f"{frames * THREADS * 4} B of shared memory > "
                f"{TW.SMEM_LIMIT} B")
        return chunks, frames

    def device_table(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            t = self._tables.get(device)
            if t is None:
                t = torch.tensor(self.table, device=device)
                self._tables[device] = t
            return t


@functools.lru_cache(maxsize=64)
def encode(prog: TP.TemporalProgram,
           compute_dtype: torch.dtype = torch.float32) -> LiftTable:
    """Encode ``prog`` for the kernel (memoized per process)."""
    table = table_rows(prog, compute_dtype)
    table.setflags(write=False)
    return LiftTable(program=prog, compute_dtype=compute_dtype,
                     reach=reach(prog), table=table)


# ---------------------------------------------------------------------------
# Build and bind (first launch on a CUDA tensor)
# ---------------------------------------------------------------------------

def _bind(lib) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.temporal_lift_launch.argtypes = (
        [p] + [p, q, q] * 4 + [i, i, q, i, i, i, i, i, p, p])
    lib.temporal_lift_launch.restype = i


LIBRARY = TW.KernelLibrary(SOURCE, _bind)
KERNEL = TW.Kernel("temporal_lift", LIBRARY)


# ---------------------------------------------------------------------------
# Wrappers (the plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _check_program(prog: TP.TemporalProgram, inverse: bool) -> None:
    if prog.inverse != inverse:
        want = "an inverse" if inverse else "a forward"
        raise ValueError(f"temporal_lift {'inverse' if inverse else 'forward'}"
                         f" takes {want} program, got {prog.wavelet!r} with "
                         f"inverse={prog.inverse}")


def _check_volume(t: torch.Tensor, what: str) -> None:
    if t.dim() < 3:
        raise ValueError(f"temporal_lift {what} must be (..., T, H, W), got "
                         f"{tuple(t.shape)}")
    if t.dtype not in IO_CODES:
        raise TypeError(f"temporal_lift I/O dtype {t.dtype} unsupported; "
                        f"supported: {tuple(IO_CODES)}")


def _layout(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """The leading dims of ``t`` as one batch, ``(volumes, stride)``, as
    the kernel addresses a side; None where the ``(H, W)`` plane is not
    contiguous or the leading dims do not collapse to one stride."""
    h, w = t.shape[-2:]
    if not ((w == 1 or t.stride(-1) == 1) and (h == 1 or t.stride(-2) == w)):
        return None
    dims = [(n, s) for n, s in zip(t.shape[:-3], t.stride()[:-3]) if n != 1]
    if any(outer != inner * n
           for (_, outer), (n, inner) in zip(dims, dims[1:])):
        return None
    return (int(np.prod(t.shape[:-3], dtype=np.int64)),
            dims[-1][1] if dims else 0)


def _addressable(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``t`` and its batch layout; a layout the kernel cannot address
    (a transposed plane, one channel of a channels-last video, permuted
    batch dims) is made contiguous first, as K1's polyphase split
    normalises any layout.  Contiguous volumes and views along T launch
    in place."""
    layout = _layout(t)
    if layout is None:
        t = t.contiguous()
        layout = _layout(t)
    return t, layout


def _check_compute(compute_dtype: torch.dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"temporal_lift compute dtype {compute_dtype} "
                         f"unsupported; supported: {COMPUTE_DTYPES}")


def _launch(lift: LiftTable, sides, batch: int, pairs: int, plane: int,
            io_dtype: torch.dtype, device: torch.device) -> None:
    if -(-plane // THREADS) >= 2 ** 31:
        raise ValueError(f"temporal_lift: a {plane}-sample plane exceeds "
                         f"the grid")
    chunks, frames = lift.chunking(pairs)
    lib = KERNEL.library()
    table = lift.device_table(device)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.temporal_lift_launch(
            table.data_ptr(), *[v for side in sides for v in side], batch,
            pairs, plane, chunks, frames, IO_CODES[io_dtype],
            int(lift.compute_dtype == torch.bfloat16), device.index, stream,
            info)
    LIBRARY.check(err, "temporal_lift")
    KERNEL.launched(info)


def temporal_lift_forward(x: torch.Tensor, prog: TP.TemporalProgram,
                          compute_dtype: torch.dtype = torch.float32):
    """One forward temporal level: ``(..., T, H, W)`` -> ``(low, high)``
    with ``T/2`` frames each, as :func:`TP.temporal_forward`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (and count one launch) or raise; a layout the kernel cannot address
    is made contiguous first (:func:`_addressable`)."""
    _check_program(prog, inverse=False)
    _check_compute(compute_dtype)
    dev = x.device
    if dev.type == "cpu":
        return TP.temporal_forward(x, prog, compute_dtype)
    _check_volume(x, "input")
    if x.shape[TP.TIME_AXIS] % 2:
        raise ValueError(
            f"temporal axis must be even, got T={x.shape[TP.TIME_AXIS]} "
            f"in shape {tuple(x.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"temporal_lift runs on cuda or cpu tensors, got "
                         f"{dev}")
    *lead, t, h, w = x.shape
    shape = tuple(lead) + (t // 2, h, w)
    lo = torch.empty(shape, dtype=x.dtype, device=dev)
    hi = torch.empty(shape, dtype=x.dtype, device=dev)
    if x.numel() == 0:
        return lo, hi
    x, (batch, bs) = _addressable(x)
    ts, es, plane = x.stride(-3), x.element_size(), h * w
    band = (t // 2) * plane
    _launch(encode(prog, compute_dtype),
            ((x.data_ptr(), 2 * ts, bs), (x.data_ptr() + ts * es, 2 * ts, bs),
             (lo.data_ptr(), plane, band), (hi.data_ptr(), plane, band)),
            batch, t // 2, plane, x.dtype, dev)
    return lo, hi


def temporal_lift_inverse(s: torch.Tensor, d: torch.Tensor,
                          prog: TP.TemporalProgram,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """One inverse temporal level: ``(low, high)`` -> ``(..., T, H, W)``,
    as :func:`TP.temporal_inverse` (``prog`` the inverse program).

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (and count one launch) or raise; a layout the kernel cannot address
    is made contiguous first (:func:`_addressable`)."""
    _check_program(prog, inverse=True)
    _check_compute(compute_dtype)
    dev = s.device
    if dev.type == "cpu" and d.device.type == "cpu":
        return TP.temporal_inverse(s, d, prog, compute_dtype)
    _check_volume(s, "low band")
    _check_volume(d, "high band")
    if s.shape != d.shape or s.dtype != d.dtype or s.device != d.device:
        raise ValueError(
            f"temporal_lift bands disagree: {tuple(s.shape)} {s.dtype} "
            f"{s.device} vs {tuple(d.shape)} {d.dtype} {d.device}")
    if dev.type != "cuda":
        raise ValueError(f"temporal_lift runs on cuda or cpu tensors, got "
                         f"{dev}")
    *lead, p, h, w = s.shape
    x = torch.empty(tuple(lead) + (2 * p, h, w), dtype=s.dtype, device=dev)
    if x.numel() == 0:
        return x
    (s, (batch, sbs)), (d, (_, dbs)) = _addressable(s), _addressable(d)
    plane = h * w
    vol = 2 * p * plane
    _launch(encode(prog, compute_dtype),
            ((s.data_ptr(), s.stride(-3), sbs),
             (d.data_ptr(), d.stride(-3), dbs),
             (x.data_ptr(), 2 * plane, vol),
             (x.data_ptr() + plane * x.element_size(), 2 * plane, vol)),
            batch, p, plane, s.dtype, dev)
    return x
