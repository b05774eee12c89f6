"""Non-separable polyconvolution through the window kernel (paper
Section 4, Figure 4).

One launch per predict/update pair applying

    N_{P,U} = [[V*V, V*U, U*V, U*U],
               [V*P, V*,  U*P, U* ],
               [P*V, P*U, V,   U  ],
               [P*P, P*,  P,   1  ]],   V = PU + 1.

For CDF 9/7 (K=2): 2 steps with 5x5...3x3 filters — half the operations
of the non-separable convolution.  "Makes sense only when K > 1" (paper
§5): for K=1 wavelets this degenerates to the non-separable
convolution.

On CPU tensors the kernel's plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import apply_scheme_cuda

SCHEME = "ns-polyconv"


def forward(x: torch.Tensor, wavelet: str = "cdf97", *,
            optimize: bool = False, fuse: str = "none",
            tap_opt: str = "full"):
    """One forward level of ns-polyconv: (..., H, W) -> (LL, HL, LH, HH)."""
    return apply_scheme_cuda(x, wavelet=wavelet, scheme=SCHEME,
                             optimize=optimize, fuse=fuse, tap_opt=tap_opt)
