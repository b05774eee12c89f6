"""Non-separable lifting through the window kernel (paper Section 4,
Figure 5).

Two spatial steps per predict/update pair:  S_U | T_P  with

    T_P = [[1,0,0,0],[P,1,0,0],[P*,0,1,0],[PP*,P*,P,1]]
    S_U = [[1,U,U*,UU*],[0,1,0,U*],[0,0,1,U],[0,0,0,1]]

i.e. 2 launches (device-memory round trips) per pair vs. the separable
lifting's 4 — the paper's step-halving applied to the lifting
structure.

On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import apply_scheme_cuda

SCHEME = "ns-lifting"


def forward(x: torch.Tensor, wavelet: str = "cdf97", *,
            optimize: bool = False, fuse: str = "none",
            tap_opt: str = "full"):
    """One forward level of ns-lifting: (..., H, W) -> (LL, HL, LH, HH)."""
    return apply_scheme_cuda(x, wavelet=wavelet, scheme=SCHEME,
                             optimize=optimize, fuse=fuse, tap_opt=tap_opt)
