"""The window kernel: one compiled tap program over four polyphase planes.

Replaces the reference package's Pallas window kernel
``kernels/polyphase.py::_steps_pallas_call`` (one barrier step, or one
fused step group, of a 2-D polyphase scheme).  The CUDA source is
``repro_torch/csrc/tap_window.cu``; this module encodes programs for it,
builds it with ``nvcc`` at first use, launches it through ``ctypes`` and
keeps its plain version, :func:`tap_window_ref`.

What bounds it on an H100: device-memory bytes in principle.  A launch
reads the four input planes and writes the four output planes; the
arithmetic (a few dozen flops per sample even for the fused 9/7
programs) sits below the card's fp32 rate at 3.35 TB/s.  In practice the
walk of the program table is what costs: barriers, dependent shared
loads, latency.  What the design does about it:

* **waves**: at plan build the nodes are grouped into dependency waves (a
  node's wave is one more than the highest wave of its sources; inputs
  are wave 0).  Nodes of one wave do not read each other, so the kernel
  evaluates them together and puts one barrier after each wave, not
  after each node;
* **one flat index per wave**: a thread takes its positions of the wave
  (a warp 32 x E consecutive ones of the union of the wave's regions, E
  chosen per table by :func:`choose_elems`) and evaluates every node of
  the wave there in turn: each term is one table read that serves E
  independent shared reads,
  multiplies and adds, with no branch in the term loop (reading each
  distinct ``(source, shift)`` of a wave once instead took a dispatch per
  table row and lost on the card: PERF.md);
* **persistent blocks, staged inputs**: the grid is the resident block
  count; each block loops over tiles, and the next tile's four input
  windows are requested through ``cp.async`` as soon as the current
  tile's walk ends, while the other resident blocks compute (a second
  input stage, to copy them during the walk, cost a resident block and
  lost on the card); the guard picks a block that leaves
  :data:`MIN_RESIDENT` blocks resident;
* every intermediate node lives in a shared-memory slot, reused once the
  last wave that reads it has run (liveness at wave granularity); output
  nodes nobody reads again are written straight to device memory from
  registers; windows are gathered straight from the unpadded planes with
  mod-``hp`` / mod-``wp`` indexing, and the ragged edge is masked.

One generic kernel walks an encoded table, so one build serves every
wavelet, scheme and compile level.  Products and sums use ``__fmul_rn`` /
``__fadd_rn`` in the same left-fold term order as the plain version, so
the two agree bit for bit in float32; ``compute_dtype="bfloat16"`` rounds
every product and sum to bfloat16, which float32 emulates exactly.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compiler import ir
from repro_torch.compiler.execute import required_margins, run_window
from repro_torch.core.schemes import coef
from repro_torch.kernels.polyphase import _pick_block

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "tap_window.cu"
#: device functions shared with the fused-pyramid kernels
HEADER = CSRC / "window_common.cuh"
#: build directory: ``$REPRO_TORCH_BUILD_DIR``, else ``build/repro_torch``
#: at the root of the checkout
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: shared memory one block may use on Hopper (sm_90: 227 KB)
SMEM_LIMIT = 232448
#: plane-space block target (bh, bw).  The reference's (256, 512) is sized
#: for a 16 MiB TPU VMEM; here a block's windows live in shared memory.
BLOCK_TARGET = (32, 64)
#: the guard halves the target until this many blocks fit one SM's
#: shared memory: the walk is latency-bound, and on the card a block that
#: leaves fewer resident lost to a smaller one (the fused 9/7 level at
#: (32, 64) against (32, 32): PERF.md)
MIN_RESIDENT = 3
#: shared memory of one SM on Hopper, and what the runtime reserves per
#: resident block
SM_SMEM, BLOCK_RESERVED = 233472, 1024
#: the SMEM guard never shrinks a block edge below this
MIN_BLOCK = 8
#: the encoder refuses block edges above this (no guard picks one)
MAX_BLOCK_EDGE = 256
#: the kernels map a flat window index i to its row with one float
#: multiply (``row_of`` in csrc/window_common.cuh), exact for every
#: i < 2^22 at any width.  Both encoders refuse windows past these
#: bounds: one fp32 slot of MAX_WINDOW_ELEMS positions already fills the
#: shared memory, and the CPU tests check the formula against integer
#: division for every width up to MAX_WINDOW_WIDTH at every index below
#: MAX_WINDOW_ELEMS.
MAX_WINDOW_ELEMS = SMEM_LIMIT // 4
MAX_WINDOW_WIDTH = 1024
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
IO_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

# table layout, shared with csrc/window_common.cuh
_HEADER = 12         # see table_rows
_WAVE_INTS = 4       # first node, nodes, lo, hi
_NODE_INTS = 4       # first term, terms, slot offset, output mask
#: the kernel's threads per block, and the positions per thread and pass
#: its walk is built for (the encoder picks one per table:
#: :func:`choose_elems`; the back pad covers a pass's overrun past a
#: wave's last position)
THREADS, ELEMS_CHOICES = 256, (4, 6, 9)


class SmemError(ValueError):
    """A program whose window does not fit in shared memory even at the
    smallest block."""


# ---------------------------------------------------------------------------
# Program layout and encoding (plan-build time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """Block-independent facts of one program: which nodes run and in
    which dependency wave, the region margin of each, its shared-memory
    slot and its output mask."""

    order: Tuple[int, ...]                  # lincomb node ids, wave order
    margins: Tuple[Optional[Tuple[int, int]], ...]
    waves: Tuple[int, ...]                  # per node id, -1 = dead
    slots: Tuple[int, ...]                  # per node id, -1 = none
    masks: Tuple[int, ...]                  # per node id, output bits
    n_slots: int
    n_terms: int

    @property
    def n_waves(self) -> int:
        """Dependency waves of lincomb nodes (inputs are wave 0)."""
        return max(self.waves) if self.order else 0

    @property
    def barriers(self) -> int:
        """Barriers per tile: one after the inputs, one per wave."""
        return 1 + self.n_waves

    def wave_nodes(self, w: int) -> Tuple[int, ...]:
        return tuple(i for i in self.order if self.waves[i] == w)


@functools.lru_cache(maxsize=1024)
def layout(prog: ir.TapProgram, out_margin: Optional[int] = None
           ) -> _Layout:
    """Wave and liveness pass: the nodes the kernel runs (outputs'
    ancestors), each node's wave and region margin with the outputs at
    ``out_margin`` (default: the program halo, the window kernel's case),
    and a shared-memory slot for every lincomb node a later wave reads,
    reused once the last wave that reads its holder has run.  Inputs live
    in the input stage (plane ``j``), outputs nothing reads take no
    slot."""
    r = prog.halo if out_margin is None else int(out_margin)
    req = required_margins(prog, r)
    n = len(prog.nodes)
    masks = [0] * n
    for k, o in enumerate(prog.outputs):
        masks[o] |= 1 << k
    if any(prog.nodes[o].kind == "input" for o in prog.outputs):
        raise ValueError("window programs must not output an input node "
                         "as is")
    waves = [-1] * n
    for i, nd in enumerate(prog.nodes):
        if nd.kind == "input":
            waves[i] = 0
        elif req[i] is not None:
            waves[i] = 1 + max((waves[t.src] for t in nd.terms), default=0)
    last = [0] * n                          # last wave that reads a node
    for i, nd in enumerate(prog.nodes):
        if waves[i] > 0:
            for t in nd.terms:
                last[t.src] = max(last[t.src], waves[i])
    slots = [-1] * n
    holders: Dict[int, int] = {}            # slot -> node holding it
    n_slots = 0
    order: List[int] = []
    for w in range(1, max(waves) + 1):
        for s, h in list(holders.items()):
            if last[h] < w:
                del holders[s]
        nodes = [i for i in range(n) if waves[i] == w]
        for i in nodes:
            if last[i] > w:
                s = next(s for s in range(n_slots + 1) if s not in holders)
                holders[s] = i
                slots[i] = s
                n_slots = max(n_slots, s + 1)
        order += nodes
    n_terms = sum(len(prog.nodes[i].terms) for i in order)
    margins = tuple((0, 0) if prog.nodes[i].kind == "input" else req[i]
                    for i in range(n))
    return _Layout(order=tuple(order), margins=margins, waves=tuple(waves),
                   slots=tuple(slots), masks=tuple(masks), n_slots=n_slots,
                   n_terms=n_terms)


def table_ints(lay: _Layout) -> int:
    return (_HEADER + _WAVE_INTS * lay.n_waves + _NODE_INTS * len(lay.order)
            + 2 * lay.n_terms)


def pads(halo: int, ww: int, elems: int) -> Tuple[int, int]:
    """Floats of shared memory before the input stage and after the
    slots: a position off its node's region reads up to ``halo`` rows and
    columns outside its source, and a pass runs up to ``32 * (elems - 1)``
    positions past a wave's last (rounded up to 16 bytes)."""
    reach = halo * ww + halo
    front = -(-reach // 4) * 4
    back = -(-(reach + 32 * (elems - 1)) // 4) * 4
    return front, back


def wave_ranges(lay: _Layout, wh: int, ww: int) -> List[Tuple[int, int]]:
    """The flat window range [lo, hi) each wave walks: the union of its
    nodes' regions, positions ``y * ww + x``."""
    out = []
    for w in range(1, lay.n_waves + 1):
        rec = lay.wave_nodes(w)
        out.append((min(lay.margins[i][1] * ww + lay.margins[i][0]
                        for i in rec),
                    max((wh - lay.margins[i][1]) * ww - lay.margins[i][0]
                        for i in rec)))
    return out


def choose_elems(lay: _Layout, wh: int, ww: int) -> int:
    """Positions per thread for the walk of ``lay`` over a ``wh x ww``
    window: the count of :data:`ELEMS_CHOICES` with the fewest position
    slots per thread over all waves (a pass costs the same however few of
    its positions lie in the wave), the smaller on a tie."""
    ranges = wave_ranges(lay, wh, ww)
    return min(ELEMS_CHOICES, key=lambda e: (sum(
        -(-(hi - lo) // (THREADS * e)) * e for lo, hi in ranges), e))


def walk_terms(prog: ir.TapProgram, lay: _Layout, wh: int, ww: int) -> int:
    """Term evaluations of one walk of ``prog`` over a ``wh x ww`` window:
    each lincomb node's region times its term count (the useful work per
    block; the wave walk also evaluates a node off its region, inside the
    union of its wave's regions, and discards those values)."""
    n = 0
    for i in lay.order:
        qm, qn = lay.margins[i]
        n += (wh - 2 * qn) * (ww - 2 * qm) * len(prog.nodes[i].terms)
    return n


def check_window(wh: int, ww: int) -> None:
    """Refuse a window the kernels' float row mapping is not proven
    exact for (see :data:`MAX_WINDOW_ELEMS`)."""
    if ww > MAX_WINDOW_WIDTH or wh * ww > MAX_WINDOW_ELEMS:
        raise ValueError(
            f"window {wh}x{ww} exceeds the kernels' bounds (width <= "
            f"{MAX_WINDOW_WIDTH}, at most {MAX_WINDOW_ELEMS} positions)")


def table_rows(prog: ir.TapProgram, lay: _Layout, wh: int, ww: int,
               halo: int, compute_dtype: str,
               elems: Optional[int] = None) -> np.ndarray:
    """One program's table (see csrc/window_common.cuh) for a ``wh x ww``
    window of halo ``halo``, walked with ``elems`` positions per thread
    (default :func:`choose_elems`):

    * header (12 ints): barriers per tile, waves, nodes, terms, slots,
      halo, wh, ww, front pad, back pad, positions per thread, 0;
    * one record per dependency wave (4 ints): first node, nodes, and the
      flat window range [lo, hi) the wave walks (the union of its nodes'
      regions, positions ``y * ww + x``);
    * one record per node, wave by wave (4 ints): first term, terms, the
      offset of its slot from the first slot (-1 = none), output mask;
    * the terms (2 ints): the offset from the input stage to the source
      at the term's shift (plane ``j`` of the stage for an input, the
      slot otherwise; the slots follow the stage), coefficient bits.
    """
    check_window(wh, ww)
    cdt = COMPUTE_DTYPES[compute_dtype]
    plane = wh * ww
    elems = choose_elems(lay, wh, ww) if elems is None else int(elems)
    if elems not in ELEMS_CHOICES:
        raise ValueError(f"elems {elems} not one of {ELEMS_CHOICES}")
    front, back = pads(halo, ww, elems)
    waves: List[int] = []
    nodes: List[int] = []
    terms: List[int] = []
    for w, (lo, hi) in enumerate(wave_ranges(lay, wh, ww), 1):
        rec = lay.wave_nodes(w)
        waves += [len(nodes) // _NODE_INTS, len(rec), lo, hi]
        for i in rec:
            s = lay.slots[i]
            nodes += [len(terms) // 2, len(prog.nodes[i].terms),
                      s * plane if s >= 0 else -1, lay.masks[i]]
            for t in prog.nodes[i].terms:
                src = prog.nodes[t.src]
                if src.kind == "input":
                    base = src.j * plane
                else:
                    assert lay.slots[t.src] >= 0, \
                        f"node {i} reads node {t.src}, which has no slot"
                    base = (4 + lay.slots[t.src]) * plane
                terms += [base - t.kn * ww - t.km,
                          int(np.array(coef(t.c, cdt), np.float32)
                              .view(np.int32))]
    header = [lay.barriers, lay.n_waves, len(lay.order), lay.n_terms,
              lay.n_slots, halo, wh, ww, front, back, elems, 0]
    return np.array(header + waves + nodes + terms, np.int32)


def smem_floats(lay: _Layout, wh: int, ww: int, halo: int,
                elems: Optional[int] = None) -> int:
    """Shared memory of one walk in 4-byte words, as the kernels lay it
    out: the table (rounded up to 16 bytes), the front pad, the input
    stage of four windows, the slots, the back pad (for ``elems``
    positions per thread, default :func:`choose_elems`)."""
    elems = choose_elems(lay, wh, ww) if elems is None else elems
    front, back = pads(halo, ww, elems)
    table = -(-table_ints(lay) // 4) * 4
    return table + front + (4 + lay.n_slots) * wh * ww + back


def smem_bytes(prog: ir.TapProgram, block: Tuple[int, int],
               elems: Optional[int] = None) -> int:
    """Dynamic shared memory of one launch at ``block``."""
    r = prog.halo
    return 4 * smem_floats(layout(prog), block[0] + 2 * r,
                           block[1] + 2 * r, r, elems)


def resident_blocks(smem: int) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory that fit on one
    SM at once (shared memory only)."""
    return min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // THREADS)


def fit_block(programs: Sequence[ir.TapProgram], hp: int, wp: int,
              target: Tuple[int, int] = BLOCK_TARGET,
              limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """SMEM guard: the largest block (from ``target``, halving the longer
    edge) at which every program's launch fits in ``limit`` bytes of
    shared memory and :data:`MIN_RESIDENT` blocks fit one SM (or, where
    none does, the smallest block that fits ``limit``).  Raises
    :class:`SmemError` when even the smallest block does not fit."""
    t = (int(target[0]), int(target[1]))
    while True:
        block = (_pick_block(hp, t[0])[0], _pick_block(wp, t[1])[0])
        need = max(smem_bytes(p, block) for p in programs)
        if t[0] >= t[1] and t[0] > MIN_BLOCK:
            smaller = (max(t[0] // 2, MIN_BLOCK), t[1])
        elif t[1] > MIN_BLOCK:
            smaller = (t[0], max(t[1] // 2, MIN_BLOCK))
        elif t[0] > MIN_BLOCK:
            smaller = (max(t[0] // 2, MIN_BLOCK), t[1])
        else:
            smaller = None
        if need <= limit and (resident_blocks(need) >= MIN_RESIDENT
                              or smaller is None):
            return block
        if smaller is None:
            raise SmemError(
                f"tap program window at block {block} needs {need} B of "
                f"shared memory > limit {limit} B even at the minimum "
                f"block")
        t = smaller


@dataclasses.dataclass(eq=False)
class WindowProgram:
    """One program encoded for the window kernel at one block size.

    ``table`` is the int32 program table the kernel walks; it is uploaded
    once per device (:meth:`device_table`) and reused by every launch.
    """

    program: ir.TapProgram
    block: Tuple[int, int]
    compute_dtype: str
    halo: int
    table: np.ndarray
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def window(self) -> Tuple[int, int]:
        return (self.block[0] + 2 * self.halo, self.block[1] + 2 * self.halo)

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.program, self.block, self.elems)

    @property
    def barriers(self) -> int:
        """Barriers per tile (table header)."""
        return int(self.table[0])

    @property
    def terms(self) -> int:
        """Terms per position, one shared read each (table header)."""
        return int(self.table[3])

    @property
    def elems(self) -> int:
        """Positions per thread and pass of the walk (table header)."""
        return int(self.table[10])

    def tiles(self, shape: Tuple[int, int, int]) -> int:
        nb, hp, wp = shape
        return nb * -(-hp // self.block[0]) * -(-wp // self.block[1])

    def term_evaluations(self, shape: Tuple[int, int, int]) -> int:
        """Term evaluations of one launch over ``(B, hp, wp)`` planes."""
        return self.tiles(shape) * walk_terms(
            self.program, layout(self.program), *self.window)

    def device_table(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            t = self._tables.get(device)
            if t is None:
                t = torch.tensor(self.table, device=device)
                self._tables[device] = t
            return t


def encode(prog: ir.TapProgram, block: Tuple[int, int],
           compute_dtype: str = "float32") -> WindowProgram:
    """Encode ``prog`` for launches at ``block`` (see the table layout in
    ``csrc/window_common.cuh``)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"available: {tuple(COMPUTE_DTYPES)}")
    if not all(1 <= int(e) <= MAX_BLOCK_EDGE for e in block):
        raise ValueError(f"block {tuple(block)} outside 1..{MAX_BLOCK_EDGE} "
                         f"per edge")
    lay = layout(prog)
    r = prog.halo
    table = table_rows(prog, lay, block[0] + 2 * r, block[1] + 2 * r, r,
                       compute_dtype)
    table.setflags(write=False)
    return WindowProgram(program=prog, block=(int(block[0]), int(block[1])),
                         compute_dtype=compute_dtype, halo=r, table=table)


# ---------------------------------------------------------------------------
# Build and bind (first launch on a CUDA tensor)
# ---------------------------------------------------------------------------

def _build_dir() -> Path:
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc(source: Path) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            f"and PATH); the kernels of {source.name} are built from "
            f"{source} at their first launch on a CUDA tensor")
    return found


class KernelLibrary:
    """One CUDA source, built with nvcc into a shared library with a
    plain C interface at the first launch on a CUDA tensor (keyed by the
    hash of the source, its headers and the flags) and bound with ctypes
    by ``bind``.  The source exports ``<stem>_error_string``."""

    def __init__(self, source: Path, bind, headers: Sequence[Path] = (HEADER,)):
        self.source = Path(source)
        self.headers = tuple(Path(h) for h in headers)
        self._bind = bind
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""
        self.path: Optional[Path] = None
        self._lib = None
        self._lock = threading.Lock()

    def library(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load(self._build())
            return self._lib

    def _build(self) -> Path:
        stem = self.source.stem
        data = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in self.headers)
        digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"{stem}-{digest}.so"
        log = out_dir / f"{stem}-{digest}.ptxas.txt"
        if not lib.exists():
            tmp = out_dir / f".{stem}-{digest}.{os.getpid()}.so"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp),
                 str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {self.source} (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            self.build_seconds = time.perf_counter() - t0
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        self.ptxas_log = log.read_text() if log.exists() else ""
        self.path = lib
        return lib

    def _load(self, path: Path):
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, f"{self.source.stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._bind(lib)
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error."""
        if err != 0:
            msg = getattr(self.library(),
                          f"{self.source.stem}_error_string")(err).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                               f"({msg})")


class Kernel:
    """One kernel of a :class:`KernelLibrary` and its launch counter.

    ``launches`` counts kernel launches and nothing else: the plain
    version (CPU tensors) never touches it.
    """

    def __init__(self, name: str, library: KernelLibrary):
        self.name = name
        self.lib = library
        self.launches = 0
        #: (grid, resident blocks per SM) of the last launch
        self.last_grid: Tuple[int, int] = (0, 0)

    def library(self):
        return self.lib.library()

    def launched(self, info) -> None:
        """Count one launch; ``info`` is the (grid, blocks per SM) pair
        the launch function wrote."""
        self.launches += 1
        self.last_grid = (int(info[0]), int(info[1]))


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tap_window_launch.argtypes = [p, i] + [p] * 8 + [i] * 11 + [p, p]
    lib.tap_window_launch.restype = i


LIBRARY = KernelLibrary(SOURCE, _bind)
KERNEL = Kernel("tap_window", LIBRARY)


# ---------------------------------------------------------------------------
# Wrapper and plain version
# ---------------------------------------------------------------------------

def _check(win: WindowProgram, planes: Sequence[torch.Tensor]) -> None:
    if len(planes) != 4:
        raise ValueError(f"tap_window takes 4 planes, got {len(planes)}")
    p0 = planes[0]
    if p0.dim() != 3:
        raise ValueError(f"tap_window planes must be (B, hp, wp), got "
                         f"{tuple(p0.shape)}")
    if p0.dtype not in IO_CODES:
        raise TypeError(f"tap_window I/O dtype {p0.dtype} unsupported; "
                        f"supported: {tuple(IO_CODES)}")
    for p in planes[1:]:
        if p.shape != p0.shape or p.dtype != p0.dtype \
                or p.device != p0.device:
            raise ValueError(
                f"tap_window planes disagree: {tuple(p.shape)} {p.dtype} "
                f"{p.device} vs {tuple(p0.shape)} {p0.dtype} {p0.device}")


def window_ref(prog: ir.TapProgram, planes: Sequence[torch.Tensor],
               compute_dtype: str) -> Tuple[torch.Tensor, ...]:
    """:func:`run_window` of ``prog`` over windows of halo ``prog.halo``
    gathered from ``(..., hp, wp)`` planes with mod indexing, computed in
    ``compute_dtype`` and cast back to the planes' dtype."""
    r = prog.halo
    hp, wp = planes[0].shape[-2:]
    dev = planes[0].device
    ri = torch.arange(-r, hp + r, device=dev) % hp
    ci = torch.arange(-r, wp + r, device=dev) % wp
    cdt = COMPUTE_DTYPES[compute_dtype]
    xs = [p.index_select(-2, ri).index_select(-1, ci).to(cdt)
          for p in planes]
    ys = run_window(prog, xs, r)
    return tuple(y.to(planes[0].dtype) for y in ys)


def tap_window_ref(win: WindowProgram, planes: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel: :func:`run_window` over windows
    gathered with the kernel's mod indexing (one window per plane)."""
    _check(win, planes)
    return window_ref(win.program, planes, win.compute_dtype)


def tap_window(win: WindowProgram, planes: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, ...]:
    """Run one encoded program over four ``(B, hp, wp)`` planes.

    CUDA tensors launch the kernel (and count one launch) or raise; CPU
    tensors run :func:`tap_window_ref`.
    """
    _check(win, planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return tap_window_ref(win, planes)
    if dev.type != "cuda":
        raise ValueError(f"tap_window runs on cuda or cpu tensors, got "
                         f"{dev}")
    for p in planes:
        if not p.is_contiguous():
            raise ValueError("tap_window planes must be contiguous")
    nb, hp, wp = planes[0].shape
    if win.tiles((nb, hp, wp)) >= 2 ** 31:
        raise ValueError(f"tap_window: {win.tiles((nb, hp, wp))} tiles "
                         f"exceed the kernel's int32 tile index")
    lib = KERNEL.library()
    outs = [torch.empty_like(p) for p in planes]
    table = win.device_table(dev)
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tap_window_launch(
            table.data_ptr(), int(table.numel()),
            *[p.data_ptr() for p in planes], *[o.data_ptr() for o in outs],
            nb, hp, wp, *win.block, win.halo, win.smem_bytes, win.elems,
            IO_CODES[planes[0].dtype],
            int(win.compute_dtype == "bfloat16"), dev.index, stream, info)
    LIBRARY.check(err, "tap_window")
    KERNEL.launched(info)
    return tuple(outs)
