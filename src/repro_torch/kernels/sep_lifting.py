"""Separable lifting through the window kernel — fewest MACs, most
device-memory round trips.

4 launches per predict/update pair: S_U^V | S_U^H | T_P^V | T_P^H.
On a memory-bound platform the barrier count dominates; this scheme is
the "many cheap steps" end of the paper's trade-off space.

On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import apply_scheme_cuda

SCHEME = "sep-lifting"


def forward(x: torch.Tensor, wavelet: str = "cdf97", *,
            optimize: bool = False, fuse: str = "none",
            tap_opt: str = "full"):
    """One forward level of sep-lifting: (..., H, W) -> (LL, HL, LH, HH)."""
    return apply_scheme_cuda(x, wavelet=wavelet, scheme=SCHEME,
                             optimize=optimize, fuse=fuse, tap_opt=tap_opt)
