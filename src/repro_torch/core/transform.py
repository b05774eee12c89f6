"""Multi-level 2-D DWT / inverse DWT public API (engine-backed).

    pyr  = dwt2(img, wavelet="cdf97", levels=3, scheme="ns-polyconv")
    img2 = idwt2(pyr, wavelet="cdf97", scheme="ns-polyconv")

A pyramid is ``(LL_L, [(HL_l, LH_l, HH_l) for l in L..1])`` — the coarsest
approximation plus per-level detail triples, coarsest first.

Both functions are thin wrappers over the plan/executor engine
(:mod:`repro_torch.engine`): every call resolves a
:class:`~repro_torch.engine.DwtPlan` from the LRU plan cache keyed on
``(wavelet, scheme, levels, shape, dtype, backend, optimize, fuse,
boundary, compute_dtype, tap_opt, device)``.  Input may be batched
``(..., H, W)``; a batch runs in one kernel launch per barrier.

Parameters shared by :func:`dwt2` and :func:`idwt2`:

``device``
    Where the transform runs: ``"cuda"`` (the default) or ``"cpu"``.
    The input is moved there.  With no CUDA device a ``"cuda"`` request
    raises; pass ``device="cpu"`` to run on the CPU.
``backend``
    * "cuda"  — the hand-written CUDA window kernel (the default); on
      ``device="cpu"`` it runs the kernel's plain version
    * "torch" — the torch reference (roll-based periodic convolution)

    Unknown backends, the reference's backends not ported yet ("xla",
    "auto") and unsupported (backend, configuration) combinations raise
    at plan build with the offending field named.
``optimize``
    ``True`` applies the paper's Section 5 operation-reduction split
    (identical values, fewer MACs).
``fuse``
    * "none"    — paper-faithful: one kernel launch per barrier step
    * "scheme"  — one launch per level (compound halo)
    * "levels"  — as "scheme" (PyTorch runs eagerly)
    * "pyramid" — not ported on "cuda" (raises); the "torch" backend
      runs the per-level chain
``boundary``
    Only ``"periodic"`` is implemented.
"""
from __future__ import annotations

import torch

from repro_torch.engine.pyramid import Pyramid

__all__ = ["Pyramid", "dwt2", "idwt2", "validate_finite", "VALIDATE_MODES"]

#: accepted values of the ``validate`` parameter (None = no checking)
VALIDATE_MODES = (None, "nan")


def validate_finite(x, mode, what: str = "input") -> None:
    """Opt-in input validation at the plan boundary.

    ``mode=None`` is a no-op (validation costs a device sync + sweep).
    ``mode="nan"`` rejects tensors containing NaN/Inf with an actionable
    error *before* the transform runs.  Pyramids are checked plane by
    plane.
    """
    if mode is None:
        return
    if mode not in VALIDATE_MODES:
        raise ValueError(f"unknown validate mode {mode!r}; "
                         f"available: {VALIDATE_MODES}")
    if isinstance(x, Pyramid):
        validate_finite(x.ll, mode, what=f"{what} (LL plane)")
        for lvl, dd in enumerate(x.details):
            for band, d in zip(("HL", "LH", "HH"), dd):
                validate_finite(d, mode,
                                what=f"{what} ({band} plane, level {lvl})")
        return
    finite = torch.isfinite(torch.as_tensor(x))
    if not bool(finite.all()):
        bad = int(finite.numel() - finite.sum())
        raise ValueError(
            f"{what} contains {bad} non-finite value(s) (NaN/Inf), "
            f"rejected by validate='nan' at the plan boundary; sanitize "
            f"the input or drop validate to accept it")


def _on(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or an array-like) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(x, device=device)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _plan_for(shape, dtype, wavelet, levels, scheme, optimize, backend,
              fuse, boundary, compute_dtype, tap_opt, tiles, device):
    from repro_torch import engine as E  # deferred: core <-> engine
    return E.get_plan(wavelet=wavelet, scheme=scheme, levels=levels,
                      shape=tuple(shape), dtype=_dtype_name(dtype),
                      backend=backend, optimize=optimize, fuse=fuse,
                      boundary=boundary, compute_dtype=compute_dtype,
                      tap_opt=tap_opt, tiles=tiles, device=device)


def dwt2(x, wavelet: str = "cdf97", levels: int = 1,
         scheme: str = "ns-polyconv", optimize: bool = False,
         backend: str = "cuda", fuse: str = "none",
         boundary: str = "periodic", compute_dtype: str = "float32",
         tap_opt: str = "full", tiles=None, validate=None,
         device="cuda") -> Pyramid:
    """Multi-level forward 2-D DWT of a (batch of) image(s) (..., H, W).

    H and W must be divisible by 2**levels.  ``x`` (a tensor or array) is
    moved to ``device``.  ``compute_dtype`` ("float32" or "bfloat16") sets
    the arithmetic dtype — I/O stays in the input dtype.  ``tap_opt``
    selects the tap-program compiler level ("off", "exact", "full").
    ``validate="nan"`` rejects NaN/Inf inputs at the plan boundary.  See
    the module docstring for the other parameters.

    >>> import torch
    >>> from repro_torch import dwt2
    >>> img = torch.ones(2, 16, 16)          # batch of 2, periodic 16x16
    >>> pyr = dwt2(img, wavelet="cdf53", levels=2, scheme="sep-lifting",
    ...            device="cpu")
    >>> pyr.levels, tuple(pyr.ll.shape)
    (2, (2, 4, 4))
    """
    from repro_torch.engine.plan import resolve_device
    dev = resolve_device(device)
    x = _on(x, dev)
    validate_finite(x, validate, what="dwt2 input")
    plan = _plan_for(x.shape, x.dtype, wavelet, levels, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, tiles,
                     dev)
    return plan.execute(x)


def idwt2(pyr: Pyramid, wavelet: str = "cdf97",
          scheme: str = "ns-polyconv", optimize: bool = False,
          backend: str = "cuda", fuse: str = "none",
          boundary: str = "periodic", compute_dtype: str = "float32",
          tap_opt: str = "full", tiles=None, validate=None,
          device="cuda") -> torch.Tensor:
    """Inverse of :func:`dwt2` (pass the same ``wavelet``/``scheme``/
    backend arguments as the forward call).  The pyramid's planes are
    moved to ``device``; ``validate="nan"`` rejects pyramids with NaN/Inf
    coefficient planes.

    >>> import torch
    >>> from repro_torch import dwt2, idwt2
    >>> x = torch.arange(256.0).reshape(16, 16)
    >>> pyr = dwt2(x, levels=2, device="cpu")
    >>> rec = idwt2(pyr, device="cpu")
    >>> bool(torch.allclose(rec, x, atol=1e-3))
    True
    """
    from repro_torch.engine.plan import resolve_device
    dev = resolve_device(device)
    pyr = Pyramid(ll=_on(pyr.ll, dev),
                  details=[tuple(_on(d, dev) for d in det)
                           for det in pyr.details])
    validate_finite(pyr, validate, what="idwt2 input pyramid")
    ll = pyr.ll
    levels = pyr.levels
    shape = tuple(ll.shape[:-2]) + (ll.shape[-2] << levels,
                                    ll.shape[-1] << levels)
    plan = _plan_for(shape, ll.dtype, wavelet, levels, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, tiles,
                     dev)
    return plan.execute_inverse(pyr)
