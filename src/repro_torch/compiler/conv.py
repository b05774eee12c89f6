"""Conv lowering: tap programs -> fused filter banks for ``F.conv2d``.

Every node of a :class:`~repro_torch.compiler.ir.TapProgram` is a linear
function of the four input polyphase planes, so the whole program is one
linear map with finite support:

    out_o[n, m] = sum_j sum_{(km, kn)}  W[o, j, kn, km] * in_j[n-kn, m-km]

i.e. a single 4-in / 4-out bank of 2-D FIR filters (:class:`ConvSpec`),
which :func:`run_planes_conv` applies as ONE ``F.conv2d`` call per
program — batched over images via the conv's N dimension, with the
planes riding the channels.  Composition is done in float64 (NumPy) so
the taps are accurate to ~1 ulp of float32.

This is the ``backend="conv"`` execution path (the reference's
``"xla"``): one conv per *step* under ``fuse="none"``, one fused conv
per *level* otherwise.  It is a library call, not a kernel of the port:
cuDNN does the work on the card.  Its convs run at full fp32: cuDNN's
TF32 is turned off around each call (:func:`full_fp32`) and the global
setting is left as it was found.

Folding the chain into a dense filter re-associates the floating-point
arithmetic, so the lowered conv matches the program walk to fp
tolerance, not bitwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compiler import ir

__all__ = ["ConvSpec", "lower_program_to_conv", "conv_stats",
           "run_planes_conv", "full_fp32", "CONV2D"]


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """A composed filter bank: one grouped convolution.

    ``weights`` is ``(4, 4, KH, KW)`` float64 in OIHW layout (output
    plane, input plane, row tap, column tap); ``pad = (rn, rm)`` is the
    periodic pad radius per axis, with the zero shift sitting at kernel
    index ``(rn, rm)`` so ``KH = 2*rn + 1`` and ``KW = 2*rm + 1``.
    """

    weights: np.ndarray
    pad: Tuple[int, int]

    @property
    def taps(self) -> int:
        """Nonzero taps = MACs per output quad of the grouped conv."""
        return int(np.count_nonzero(self.weights))

    @property
    def kernel_shape(self) -> Tuple[int, int]:
        return self.weights.shape[2], self.weights.shape[3]


@functools.lru_cache(maxsize=512)
def lower_program_to_conv(prog: ir.TapProgram) -> ConvSpec:
    """Compose a tap program into a single 4x4 bank of 2-D filters.

    Walks the SSA nodes in order, carrying for each node its closed-form
    taps ``{(j, km, kn): c}`` over the *input* planes; a lincomb node's
    taps are the shift-composed, coefficient-scaled union of its terms'
    source taps.  Exact zeros produced by cancellation are dropped.
    """
    taps: List[Dict[Tuple[int, int, int], float]] = []
    for nd in prog.nodes:
        if nd.kind == "input":
            taps.append({(nd.j, 0, 0): 1.0})
            continue
        acc: Dict[Tuple[int, int, int], float] = {}
        for t in nd.terms:
            for (j, km, kn), c in taps[t.src].items():
                k = (j, t.km + km, t.kn + kn)
                acc[k] = acc.get(k, 0.0) + t.c * c
        taps.append({k: c for k, c in acc.items() if c != 0.0})
    outs = [taps[o] for o in prog.outputs]
    rm = max((abs(km) for tp in outs for (_, km, _) in tp), default=0)
    rn = max((abs(kn) for tp in outs for (_, _, kn) in tp), default=0)
    w = np.zeros((4, 4, 2 * rn + 1, 2 * rm + 1), np.float64)
    for o, tp in enumerate(outs):
        for (j, km, kn), c in tp.items():
            w[o, j, rn - kn, rm - km] = c
    w.setflags(write=False)
    return ConvSpec(weights=w, pad=(rn, rm))


def conv_stats(specs: Sequence[ConvSpec]) -> dict:
    """Aggregate cost of a lowered conv sequence (one transform level):
    grouped-conv launches, total nonzero taps (MACs/quad), the largest
    kernel support and the largest pad radius."""
    kh = max((s.kernel_shape[0] for s in specs), default=1)
    kw = max((s.kernel_shape[1] for s in specs), default=1)
    return {"convs": len(specs),
            "taps": sum(s.taps for s in specs),
            "kernel": (kh, kw),
            "halo": max((max(s.pad) for s in specs), default=0)}


class Calls:
    """Counts the backend's ``F.conv2d`` calls (``launches``), on any
    device."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def called(self) -> None:
        with self._lock:
            self.launches += 1


CONV2D = Calls()


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions at full fp32 (no TF32) inside the block, through
    the API this PyTorch honours: ``torch.backends.cudnn.conv.
    fp32_precision`` where it exists, else the older
    ``torch.backends.cudnn.allow_tf32``.  The setting is restored after."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        prev = conv.fp32_precision
        conv.fp32_precision = "ieee"
        try:
            yield
        finally:
            conv.fp32_precision = prev
    else:
        prev = cudnn.allow_tf32
        cudnn.allow_tf32 = False
        try:
            yield
        finally:
            cudnn.allow_tf32 = prev


def _wrap_pad(x: torch.Tensor, rn: int, rm: int) -> torch.Tensor:
    """Periodic pad of the two trailing axes by ``(rn, rm)``; mod-indexed
    gather, so radii larger than the plane are fine (tiny odd shapes,
    which ``F.pad(mode="circular")`` rejects)."""
    if rn:
        n = x.shape[-2]
        idx = torch.arange(-rn, n + rn, device=x.device) % n
        x = x.index_select(-2, idx)
    if rm:
        m = x.shape[-1]
        idx = torch.arange(-rm, m + rm, device=x.device) % m
        x = x.index_select(-1, idx)
    return x


@functools.lru_cache(maxsize=512)
def _weights(prog: ir.TapProgram, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``prog``'s composed OIHW bank in ``dtype`` on ``device`` (read
    only; made once per program, dtype and device)."""
    return torch.tensor(lower_program_to_conv(prog).weights, dtype=dtype,
                        device=device)


def _apply_conv(x: torch.Tensor, prog: ir.TapProgram) -> torch.Tensor:
    """One grouped conv of ``prog``'s bank: (N, 4, h, w) -> (N, 4, h, w),
    periodic boundary."""
    rn, rm = lower_program_to_conv(prog).pad
    xp = _wrap_pad(x, rn, rm).contiguous()
    w = _weights(prog, x.dtype, x.device)
    CONV2D.called()
    return F.conv2d(xp, w, padding=0)


def run_planes_conv(programs: Sequence[ir.TapProgram],
                    planes: Sequence[torch.Tensor],
                    compute_dtype: torch.dtype = torch.float32):
    """Execute a compiled program sequence over four batched ``(..., h, w)``
    polyphase planes as grouped convolutions (one conv per program).

    The four planes stack onto the channel axis and the leading batch
    dims flatten onto the conv's N dimension, so a whole batch is one
    conv per barrier.  Arithmetic runs in ``compute_dtype``; I/O stays in
    the planes' dtype (matching the torch and cuda executors).
    """
    out_dtype = planes[0].dtype
    x = torch.stack(tuple(planes), dim=-3)
    lead = x.shape[:-3]
    x = x.reshape((-1, 4) + x.shape[-2:]).to(compute_dtype)
    with full_fp32():
        for prog in programs:
            x = _apply_conv(x, prog)
    x = x.reshape(lead + (4,) + x.shape[-2:]).to(out_dtype)
    return tuple(x[..., j, :, :] for j in range(4))
