"""Wavelet gradient compression with error feedback (phase-cycled); the
port's copy of ``repro.core.compression``.

Every gradient tensor is laid out as a ``(H, WIDTH)`` float32 tile and
transformed with an L-level 2-D DWT (ns-polyconv, the reference's
``fuse`` default).  Each step sends one 1/4^L slice of the flattened
coefficient pyramid, cycling the slice phase with the step so that all
coefficients go out once per 4^L steps; a local error-feedback
accumulator keeps what was not sent:

    e      <- e + g
    g_hat  <- D_p(reduce(C_p(e)))       (slice p of the pyramid only)
    e      <- e - g_hat

The transforms are the port's ``dwt2``/``idwt2`` on ``g.device`` with
their default backend ``"cuda"``: on the card every barrier step is one
launch of the window kernel K1 (:mod:`repro_torch.kernels.tap_window`),
so a 2-level forward plus inverse is 8 launches per tensor; on a CPU
tensor the kernel's plain version runs.  No gradient flows through the
transform, so it runs under ``torch.no_grad``.

A DTensor leaf (the sharded train step's) is compressed whole, as the
reference compresses the global array: :func:`compress_with_feedback`
gathers each gradient and error leaf (``full_tensor()``), transforms it,
and places its outputs as the inputs were placed.  Compressing each
rank's shard would tile, and so transform, something else.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.core import transform as T
from repro_torch.distributed import sharding as SH

WIDTH = 256  # 2-D tile width for flattened gradients
SCHEME = "ns-polyconv"


def _tile_2d(g: torch.Tensor, levels: int) -> Tuple[torch.Tensor, int]:
    """Flatten to (H, WIDTH) with H divisible by (2^levels * 4^levels) so
    both the transform and the phase slicing are exact."""
    n = g.numel()
    h, w = tile_shape(n, levels)
    flat = F.pad(g.reshape(-1).to(torch.float32), (0, h * w - n))
    return flat.reshape(h, w), n


def tile_shape(numel: int, levels: int) -> Tuple[int, int]:
    """The ``(H, WIDTH)`` tile a tensor of ``numel`` elements becomes."""
    block = (1 << levels) * (4 ** levels)
    h = -(-numel // WIDTH)
    return -(-h // block) * block, WIDTH


def n_phases(levels: int) -> int:
    return 4 ** levels


def _phase(step, levels: int) -> int:
    return int(step) % n_phases(levels)


@torch.no_grad()
def compress(g: torch.Tensor, phase, levels: int = 2,
             wavelet: str = "cdf97") -> torch.Tensor:
    """Gradient tensor -> one 1/4^L slice of its coefficient pyramid."""
    tile, _ = _tile_2d(g, levels)
    pyr = T.dwt2(tile, wavelet=wavelet, levels=levels, scheme=SCHEME,
                 device=g.device)
    flat = T.flatten_pyramid(pyr)
    rows = flat.shape[0] // n_phases(levels)
    p = int(phase)
    return flat[p * rows:(p + 1) * rows].clone()  # frees the pyramid


@torch.no_grad()
def decompress(sl: torch.Tensor, phase, shape, levels: int = 2,
               wavelet: str = "cdf97") -> torch.Tensor:
    """Pyramid slice -> gradient tensor (other phases zero)."""
    n = 1
    for d in shape:
        n *= d
    rows = sl.shape[0]
    flat = torch.zeros((rows * n_phases(levels), sl.shape[1]),
                       dtype=sl.dtype, device=sl.device)
    p = int(phase)
    flat[p * rows:(p + 1) * rows] = sl
    pyr = T.unflatten_pyramid(flat, levels)
    tile = T.idwt2(pyr, wavelet=wavelet, scheme=SCHEME, device=sl.device)
    return tile.reshape(-1)[:n].reshape(tuple(shape))


def compressed_bytes_ratio(levels: int) -> float:
    return 1.0 / (4 ** levels)


# ---------------------------------------------------------------------------
# Error-feedback state
# ---------------------------------------------------------------------------

def init_error_feedback(params) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


@torch.no_grad()
def compress_with_feedback(grads, errors, step=0, levels: int = 2,
                           wavelet: str = "cdf97",
                           reduce_fn: Optional[Callable] = None):
    """Returns (decompressed grads, new error state).

    ``reduce_fn`` (e.g. an all-reduce mean over the data-parallel group)
    is applied to the *compressed* slice: that is the collective whose
    bytes shrink by 4^levels.  ``step`` selects the pyramid phase
    (cycled).  DTensor leaves are transformed whole and come back placed
    as they came (module docstring).
    """
    phase = _phase(step, levels)

    def one(g_in, e_in):
        g, e = SH.to_global(g_in), SH.to_global(e_in)
        acc = e + g.to(torch.float32)
        c = compress(acc, phase, levels, wavelet)
        if reduce_fn is not None:
            c = reduce_fn(c)
        g_hat = decompress(c, phase, g.shape, levels, wavelet)
        return SH.like(g_hat.to(g.dtype), g_in), SH.like(acc - g_hat, e_in)

    outs = [one(g, e) for g, e in zip(pytree.leaves(grads),
                                      pytree.leaves(errors))]
    new_g = pytree.unflatten(grads, [o[0] for o in outs])
    new_e = pytree.unflatten(grads, [o[1] for o in outs])
    return new_g, new_e
