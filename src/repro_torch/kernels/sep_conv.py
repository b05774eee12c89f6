"""Separable convolution through the window kernel — the classical Mallat
baseline.

Two launches: N^V | N^H (1-D filter banks applied per axis).  This is
the paper's primary baseline (its Table 1 rows 1); the non-separable
schemes halve its device-memory round trips.

On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import apply_scheme_cuda

SCHEME = "sep-conv"


def forward(x: torch.Tensor, wavelet: str = "cdf97", *,
            optimize: bool = False, fuse: str = "none",
            tap_opt: str = "full"):
    """One forward level of sep-conv: (..., H, W) -> (LL, HL, LH, HH)."""
    return apply_scheme_cuda(x, wavelet=wavelet, scheme=SCHEME,
                             optimize=optimize, fuse=fuse, tap_opt=tap_opt)
