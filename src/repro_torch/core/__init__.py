"""Scheme algebra (:mod:`poly`, :mod:`wavelets`, :mod:`schemes`,
:mod:`optimize`) and the public 2-D API (:mod:`transform`)."""
from repro_torch.core.transform import (Pyramid, dwt2, idwt2,
                                        validate_finite)

__all__ = ["Pyramid", "dwt2", "idwt2", "validate_finite"]
