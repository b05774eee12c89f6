"""The window kernel: one compiled tap program over four polyphase planes.

Replaces the reference package's Pallas window kernel
``kernels/polyphase.py::_steps_pallas_call`` (one barrier step, or one
fused step group, of a 2-D polyphase scheme).  The CUDA source is
``repro_torch/csrc/tap_window.cu``; this module encodes programs for it,
builds it with ``nvcc`` at first use, launches it through ``ctypes`` and
keeps its plain version, :func:`tap_window_ref`.

What bounds it on an H100: device-memory bytes.  A launch reads the four
input planes and writes the four output planes; the arithmetic (a few
dozen flops per sample even for the fused 9/7 programs) sits far below
the card's fp32 rate at 3.35 TB/s.  What the design does about that:

* the four ``(bh+2r) x (bw+2r)`` input windows are gathered straight from
  the unpadded planes with mod-``hp`` / mod-``wp`` indexing, so there is
  no separate periodic-pad pass and no pad-to-block copy (the Pallas path
  materializes both), and the ragged edge is masked on the store;
* every intermediate node of the program lives in shared memory, in a
  slot reused once its last reader has run (a liveness pass at plan
  build), so a fused program makes exactly one round trip of the planes
  through device memory per launch;
* output nodes nobody reads again are written straight to device memory
  from registers, taking no shared-memory slot.

One generic kernel walks an encoded program table (nodes, terms, node
regions from :func:`~repro_torch.compiler.execute.required_margins`), so
one build serves every wavelet, scheme and compile level.  Products and
sums use ``__fmul_rn`` / ``__fadd_rn`` in the same left-fold term order
and with the same strength reductions as the plain version, so the two
agree bit for bit in float32; ``compute_dtype="bfloat16"`` rounds every
product and sum to bfloat16, which float32 emulates exactly.
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
#: for a 16 MiB TPU VMEM; here a block's windows live in shared memory:
#: 11 fp32 slots of a 40 x 72 window (halo 4) take ~127 KB.
BLOCK_TARGET = (32, 64)
#: the SMEM guard never shrinks a block edge below this
MIN_BLOCK = 8
#: the encoder refuses block edges above this (no guard picks one)
MAX_BLOCK_EDGE = 256
#: the kernels map a flat region index i to its row with one float
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

# table layout, shared with csrc/tap_window.cu
_HEADER = 4          # n_nodes, n_terms, n_slots, halo
_NODE_INTS = 8       # kind, j, dst slot, qm, qn, first term, n terms, mask
_TERM_INTS = 4       # src offset, op, coefficient bits, unused
_INPUT, _LINCOMB = 0, 1
_COPY, _NEG, _MUL = 0, 1, 2


class SmemError(ValueError):
    """A program whose window does not fit in shared memory even at the
    smallest block."""


# ---------------------------------------------------------------------------
# Program layout and encoding (plan-build time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Layout:
    """Block-independent facts of one program: which nodes run, the
    region margin of each, its shared-memory slot, its output mask."""

    order: Tuple[int, ...]                  # node ids the kernel walks
    margins: Tuple[Optional[Tuple[int, int]], ...]
    slots: Tuple[int, ...]                  # per node id, -1 = none
    masks: Tuple[int, ...]                  # per node id, output bits
    n_slots: int
    n_terms: int


@functools.lru_cache(maxsize=1024)
def layout(prog: ir.TapProgram, out_margin: Optional[int] = None
           ) -> _Layout:
    """Liveness pass: the nodes the kernel runs (outputs' ancestors, in
    program order), each node's region margin with the outputs at
    ``out_margin`` (default: the program halo, the window kernel's
    case), and a shared-memory slot for every node a later node reads —
    reused once its last reader has run.  Outputs nothing reads take no
    slot."""
    r = prog.halo if out_margin is None else int(out_margin)
    req = required_margins(prog, r)
    n = len(prog.nodes)
    masks = [0] * n
    for k, o in enumerate(prog.outputs):
        masks[o] |= 1 << k
    live = [False] * n
    for i, nd in enumerate(prog.nodes):
        live[i] = (req[i] is not None if nd.kind == "lincomb"
                   else req[i] is not None or masks[i] != 0)
    last_use = [-1] * n
    for i, nd in enumerate(prog.nodes):
        if live[i] and nd.kind == "lincomb":
            for t in nd.terms:
                last_use[t.src] = max(last_use[t.src], i)
    slots = [-1] * n
    holders: Dict[int, int] = {}            # slot -> node holding it
    n_slots = 0
    order = []
    for i in range(n):
        if not live[i]:
            continue
        order.append(i)
        for s, h in list(holders.items()):
            if last_use[h] < i:
                del holders[s]
        if last_use[i] > i:
            s = next(s for s in range(n_slots + 1) if s not in holders)
            holders[s] = i
            slots[i] = s
            n_slots = max(n_slots, s + 1)
    n_terms = sum(len(prog.nodes[i].terms) for i in order)
    margins = tuple((0, 0) if prog.nodes[i].kind == "input" else req[i]
                    for i in range(n))
    return _Layout(order=tuple(order), margins=margins,
                   slots=tuple(slots), masks=tuple(masks), n_slots=n_slots,
                   n_terms=n_terms)


def table_ints(lay: _Layout) -> int:
    return _HEADER + _NODE_INTS * len(lay.order) + _TERM_INTS * lay.n_terms


def walk_terms(prog: ir.TapProgram, lay: _Layout, wh: int, ww: int) -> int:
    """Term evaluations of one walk of ``prog`` over a ``wh x ww`` window:
    each lincomb node's region times its term count (the kernels' work
    per block)."""
    n = 0
    for i in lay.order:
        nd = prog.nodes[i]
        if nd.kind != "input":
            qm, qn = lay.margins[i]
            n += (wh - 2 * qn) * (ww - 2 * qm) * len(nd.terms)
    return n


def check_window(wh: int, ww: int) -> None:
    """Refuse a window the kernels' float row mapping is not proven
    exact for (see :data:`MAX_WINDOW_ELEMS`)."""
    if ww > MAX_WINDOW_WIDTH or wh * ww > MAX_WINDOW_ELEMS:
        raise ValueError(
            f"window {wh}x{ww} exceeds the kernels' bounds (width <= "
            f"{MAX_WINDOW_WIDTH}, at most {MAX_WINDOW_ELEMS} positions)")


def table_rows(prog: ir.TapProgram, lay: _Layout, wh: int, ww: int,
               halo: int, compute_dtype: str) -> np.ndarray:
    """One program's table (see csrc/window_common.cuh) for a ``wh x ww``
    window of halo ``halo``: header, node rows, term rows."""
    check_window(wh, ww)
    cdt = COMPUTE_DTYPES[compute_dtype]
    plane = wh * ww
    node_rows: List[List[int]] = []
    term_rows: List[List[int]] = []
    for i in lay.order:
        nd = prog.nodes[i]
        qm, qn = lay.margins[i]
        kind = _INPUT if nd.kind == "input" else _LINCOMB
        node_rows.append([kind, nd.j if kind == _INPUT else 0,
                          lay.slots[i], qm, qn, len(term_rows),
                          len(nd.terms), lay.masks[i]])
        for t in nd.terms:
            src = lay.slots[t.src]
            assert src >= 0, f"node {i} reads node {t.src}, which has no slot"
            op = _COPY if t.c == 1.0 else (_NEG if t.c == -1.0 else _MUL)
            bits = int(np.array(coef(t.c, cdt), np.float32).view(np.int32))
            term_rows.append([src * plane - t.kn * ww - t.km, op, bits, 0])
    return np.array([len(node_rows), len(term_rows), lay.n_slots, halo]
                    + [v for row in node_rows for v in row]
                    + [v for row in term_rows for v in row], np.int32)


def smem_bytes(prog: ir.TapProgram, block: Tuple[int, int]) -> int:
    """Dynamic shared memory of one launch: the program table plus one
    fp32 window per slot."""
    lay = layout(prog)
    r = prog.halo
    table = (table_ints(lay) + 3) // 4 * 4
    return 4 * (table + lay.n_slots * (block[0] + 2 * r)
                * (block[1] + 2 * r))


def fit_block(programs: Sequence[ir.TapProgram], hp: int, wp: int,
              target: Tuple[int, int] = BLOCK_TARGET,
              limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """SMEM guard: the largest block (from ``target``, halving the longer
    edge) at which every program's launch fits in ``limit`` bytes of
    shared memory.  Raises :class:`SmemError` when even the smallest
    block does not fit."""
    t = (int(target[0]), int(target[1]))
    while True:
        block = (_pick_block(hp, t[0])[0], _pick_block(wp, t[1])[0])
        need = max(smem_bytes(p, block) for p in programs)
        if need <= limit:
            return block
        if t[0] >= t[1] and t[0] > MIN_BLOCK:
            t = (max(t[0] // 2, MIN_BLOCK), t[1])
        elif t[1] > MIN_BLOCK:
            t = (t[0], max(t[1] // 2, MIN_BLOCK))
        elif t[0] > MIN_BLOCK:
            t = (max(t[0] // 2, MIN_BLOCK), t[1])
        else:
            raise SmemError(
                f"tap program window at block {block} needs {need} B of "
                f"shared memory > limit {limit} B even at the minimum "
                f"block")


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
    n_nodes: int
    n_slots: int
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
        return smem_bytes(self.program, self.block)

    def term_evaluations(self, shape: Tuple[int, int, int]) -> int:
        """Term evaluations of one launch over ``(B, hp, wp)`` planes."""
        nb, hp, wp = shape
        blocks = nb * -(-hp // self.block[0]) * -(-wp // self.block[1])
        return blocks * walk_terms(self.program, layout(self.program),
                                   *self.window)

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
                         compute_dtype=compute_dtype, halo=r,
                         n_nodes=len(lay.order), n_slots=lay.n_slots,
                         table=table)


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

    def library(self):
        return self.lib.library()


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tap_window_launch.argtypes = [p, i] + [p] * 8 + [i] * 10 + [p]
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
    bh, bw = win.block
    grid_y, grid_x = -(-hp // bh), -(-wp // bw)
    if nb > 65535 or grid_y > 65535:
        raise ValueError(f"tap_window grid ({grid_x}, {grid_y}, {nb}) "
                         f"exceeds the launch limits")
    lib = KERNEL.library()
    outs = [torch.empty_like(p) for p in planes]
    table = win.device_table(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tap_window_launch(
            table.data_ptr(), int(table.numel()),
            *[p.data_ptr() for p in planes], *[o.data_ptr() for o in outs],
            nb, hp, wp, bh, bw, win.halo, win.n_slots,
            IO_CODES[planes[0].dtype],
            int(win.compute_dtype == "bfloat16"), dev.index, stream)
    LIBRARY.check(err, "tap_window")
    KERNEL.launches += 1
    return tuple(outs)
