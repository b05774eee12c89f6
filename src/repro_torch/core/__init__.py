"""Scheme algebra (:mod:`poly`, :mod:`wavelets`, :mod:`schemes`,
:mod:`optimize`), packet trees (:mod:`packets`) and the public API
(:mod:`transform`)."""
from repro_torch.core.wavelets import (CDF53, CDF97, DD137, WAVELETS,
                                       get_wavelet)
from repro_torch.core.schemes import (SCHEMES, build_inverse_scheme,
                                      build_scheme, forward, from_planes,
                                      inverse, to_planes)
from repro_torch.core.optimize import (build_optimized, forward_optimized,
                                       table1_ops)
from repro_torch.core.packets import PacketTree
from repro_torch.core.transform import (Pyramid, Pyramid3, WaveletPacket2D,
                                        best_basis, dwt2, dwt3,
                                        flatten_pyramid, idwt2, idwt3,
                                        iwpt2, unflatten_pyramid,
                                        validate_finite, wpt2)

__all__ = ["WAVELETS", "get_wavelet", "CDF53", "CDF97", "DD137",
           "SCHEMES", "build_scheme", "build_inverse_scheme", "forward",
           "inverse", "to_planes", "from_planes",
           "build_optimized", "forward_optimized", "table1_ops",
           "PacketTree", "Pyramid", "Pyramid3", "WaveletPacket2D",
           "best_basis", "dwt2", "dwt3", "flatten_pyramid", "idwt2",
           "idwt3", "iwpt2", "unflatten_pyramid", "validate_finite", "wpt2"]
