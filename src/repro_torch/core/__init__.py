"""Scheme algebra (:mod:`poly`, :mod:`wavelets`, :mod:`schemes`,
:mod:`optimize`), packet trees (:mod:`packets`) and the public API
(:mod:`transform`)."""
from repro_torch.core.packets import PacketTree
from repro_torch.core.transform import (Pyramid, Pyramid3, WaveletPacket2D,
                                        best_basis, dwt2, dwt3,
                                        flatten_pyramid, idwt2, idwt3,
                                        iwpt2, unflatten_pyramid,
                                        validate_finite, wpt2)

__all__ = ["PacketTree", "Pyramid", "Pyramid3", "WaveletPacket2D",
           "best_basis", "dwt2", "dwt3", "flatten_pyramid", "idwt2",
           "idwt3", "iwpt2", "unflatten_pyramid", "validate_finite", "wpt2"]
