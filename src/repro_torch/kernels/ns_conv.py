"""Non-separable convolution through the window kernel (paper Section 4,
Figure 3).

The full 2-D polyphase matrix N = N^V N^H applied in a SINGLE launch:
one device-memory round trip (1 step vs. the separable convolution's 2),
at the cost of the largest filters (9x9 ... 7x7 for CDF 9/7; the
Section 5 optimized variant reduces 256 -> 152 MACs/quad).

On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import apply_scheme_cuda

SCHEME = "ns-conv"


def forward(x: torch.Tensor, wavelet: str = "cdf97", *,
            optimize: bool = False, fuse: str = "none",
            tap_opt: str = "full"):
    """One forward level of ns-conv: (..., H, W) -> (LL, HL, LH, HH)."""
    return apply_scheme_cuda(x, wavelet=wavelet, scheme=SCHEME,
                             optimize=optimize, fuse=fuse, tap_opt=tap_opt)
