"""Multi-level 2-D and 3-D DWT and wavelet-packet public API
(engine-backed).

    pyr  = dwt2(img, wavelet="cdf97", levels=3, scheme="ns-polyconv")
    img2 = idwt2(pyr, wavelet="cdf97", scheme="ns-polyconv")
    pk   = wpt2(img, packet="full:2");   img3 = iwpt2(pk)
    p3   = dwt3(vol, levels=2);          vol2 = idwt3(p3)

A pyramid is ``(LL_L, [(HL_l, LH_l, HH_l) for l in L..1])`` — the coarsest
approximation plus per-level detail triples, coarsest first.

Every function is a thin wrapper over the plan/executor engine
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
    * "conv"  — the compiled tap programs as grouped ``F.conv2d`` calls
      (one per barrier step, or per level when fused; cuDNN at full
      fp32 on the card)

    Unknown backends, the reference's names for them ("jnp", "pallas",
    "xla"), the one not ported yet ("auto") and unsupported (backend,
    configuration) combinations raise at plan build with the offending
    field named.
``optimize``
    ``True`` applies the paper's Section 5 operation-reduction split
    (identical values, fewer MACs).
``fuse``
    * "none"    — paper-faithful: one kernel launch per barrier step
    * "scheme"  — one launch per level (compound halo)
    * "levels"  — as "scheme" (PyTorch runs eagerly)
    * "pyramid" — on "cuda" the whole transform in one launch of a
      fused-pyramid kernel (falls back to "levels", stated in
      ``plan.fallback``, when even the smallest block's window does not
      fit in shared memory); the "torch" backend runs the per-level
      chain
``boundary``
    Only ``"periodic"`` is implemented.
"""
from __future__ import annotations

import torch

from typing import List

from repro_torch.engine.pyramid import (Detail, Pyramid, Pyramid3,
                                        WaveletPacket2D)

__all__ = ["Pyramid", "Pyramid3", "WaveletPacket2D", "dwt2", "idwt2",
           "dwt3", "idwt3", "wpt2", "iwpt2", "best_basis",
           "flatten_pyramid", "unflatten_pyramid", "validate_finite",
           "VALIDATE_MODES"]

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
    if isinstance(x, Pyramid3):
        validate_finite(x.ll, mode, what=f"{what} (tLLL volume)")
        for lvl, dd in enumerate(x.details):
            for band, d in enumerate(dd):
                validate_finite(d, mode,
                                what=f"{what} (subband {band}, "
                                     f"level {lvl})")
        return
    if isinstance(x, WaveletPacket2D):
        for path, leaf in x.items():
            validate_finite(leaf, mode, what=f"{what} (leaf {path!r})")
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
              fuse, boundary, compute_dtype, tap_opt, tiles, device,
              packet=None, ndim=2):
    from repro_torch import engine as E  # deferred: core <-> engine
    return E.get_plan(wavelet=wavelet, scheme=scheme, levels=levels,
                      shape=tuple(shape), dtype=_dtype_name(dtype),
                      backend=backend, optimize=optimize, fuse=fuse,
                      boundary=boundary, compute_dtype=compute_dtype,
                      tap_opt=tap_opt, tiles=tiles, device=device,
                      packet=packet, ndim=ndim)


def _device(device):
    from repro_torch.engine.plan import resolve_device  # deferred, as above
    return resolve_device(device)


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
    dev = _device(device)
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
    dev = _device(device)
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


def wpt2(x, wavelet: str = "cdf97", packet="full:2",
         scheme: str = "ns-polyconv", optimize: bool = False,
         backend: str = "cuda", fuse: str = "none",
         boundary: str = "periodic", compute_dtype: str = "float32",
         tap_opt: str = "full", validate=None,
         device="cuda") -> WaveletPacket2D:
    """2-D wavelet **packet** transform of a (batch of) image(s).

    Where :func:`dwt2` recurses into the LL subband only, a packet
    transform may split any node of the subband quad-tree.  ``packet``
    names the decomposition: ``"full:D"`` (the complete depth-D tree),
    ``"dwt:L"`` (the plain pyramid, as a packet tree), an iterable of
    leaf paths over the child alphabet ``a/h/v/d`` (a=LL, h=HL, v=LH,
    d=HH), or a :class:`repro_torch.core.packets.PacketTree` — e.g. one
    pruned by :func:`best_basis`.  H and W must be divisible by
    ``2**depth``.  Every admissible leaf set reconstructs exactly via
    :func:`iwpt2`; plans are cached on the canonical leaf tuple, so
    equivalent spellings of one tree share a plan.  Each node runs one
    2-D level of ``backend`` (on "cuda", the window kernel).

    >>> import torch
    >>> from repro_torch import wpt2, iwpt2
    >>> img = torch.arange(256.0).reshape(16, 16)
    >>> pk = wpt2(img, wavelet="cdf53", packet="full:2", device="cpu")
    >>> len(pk.paths), tuple(pk.leaves[0].shape)   # 16 leaves, 4x4 each
    (16, (4, 4))
    >>> pk.paths[:4]
    ('aa', 'ah', 'av', 'ad')
    >>> rec = iwpt2(pk, wavelet="cdf53", device="cpu")
    >>> bool(torch.allclose(rec, img, atol=1e-3))
    True
    """
    dev = _device(device)
    x = _on(x, dev)
    validate_finite(x, validate, what="wpt2 input")
    plan = _plan_for(x.shape, x.dtype, wavelet, 1, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, None,
                     dev, packet=packet)
    return plan.execute(x)


def iwpt2(pk: WaveletPacket2D, wavelet: str = "cdf97",
          scheme: str = "ns-polyconv", optimize: bool = False,
          backend: str = "cuda", fuse: str = "none",
          boundary: str = "periodic", compute_dtype: str = "float32",
          tap_opt: str = "full", validate=None,
          device="cuda") -> torch.Tensor:
    """Inverse of :func:`wpt2`: exact reconstruction from any admissible
    leaf set (the packet tree is read off ``pk.paths``).  The leaves are
    moved to ``device``."""
    dev = _device(device)
    pk = WaveletPacket2D(paths=tuple(pk.paths),
                         leaves=[_on(a, dev) for a in pk.leaves])
    validate_finite(pk, validate, what="iwpt2 input packet")
    first = pk.leaves[0]
    d = len(pk.paths[0])
    shape = tuple(first.shape[:-2]) + (first.shape[-2] << d,
                                       first.shape[-1] << d)
    plan = _plan_for(shape, first.dtype, wavelet, 1, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, None,
                     dev, packet=pk.paths)
    return plan.execute_inverse(pk)


def best_basis(x, wavelet: str = "cdf97", depth: int = 2,
               cost: str = "shannon", scheme: str = "ns-polyconv",
               optimize: bool = False, backend: str = "cuda",
               fuse: str = "none", boundary: str = "periodic",
               compute_dtype: str = "float32", tap_opt: str = "full",
               device="cuda"):
    """Entropy-pruned packet tree for ``x`` (Coifman–Wickerhauser).

    Decomposes the full quad-tree to ``depth``, scores every node with
    the additive ``cost`` functional (``"shannon"``, ``"l1"`` or
    ``"threshold"``; see :mod:`repro_torch.core.packets`, evaluated in
    float64 on the host) and keeps a node whole when splitting does not
    pay.  The returned :class:`~repro_torch.core.packets.PacketTree`
    feeds straight into :func:`wpt2`'s ``packet`` argument.

    >>> import torch
    >>> from repro_torch import best_basis
    >>> tree = best_basis(torch.ones(16, 16), wavelet="cdf53", depth=2,
    ...                   device="cpu")
    >>> tree.leaves                           # nothing to split for
    ('a', 'h', 'v', 'd')
    """
    from repro_torch.core import packets as PK
    if cost not in PK.COSTS:
        raise ValueError(f"unknown cost {cost!r}; "
                         f"available: {sorted(PK.COSTS)}")
    cost_fn = PK.COSTS[cost]
    dev = _device(device)
    x = _on(x, dev)
    costs = {}

    def walk(img, path):
        # float64 on the host, exact for every floating dtype (the costs
        # cast to it anyway; Tensor.numpy() rejects bfloat16)
        costs[path] = cost_fn(img.detach().to("cpu", torch.float64).numpy())
        if len(path) == depth:
            return
        pyr = dwt2(img, wavelet=wavelet, levels=1, scheme=scheme,
                   optimize=optimize, backend=backend, fuse=fuse,
                   boundary=boundary, compute_dtype=compute_dtype,
                   tap_opt=tap_opt, device=dev)
        hl, lh, hh = pyr.details[0]
        for c, arr in zip(PK.CHILDREN, (pyr.ll, hl, lh, hh)):
            walk(arr, path + c)

    walk(x, "")
    return PK.best_basis_from_costs(costs, depth)


def dwt3(x, wavelet: str = "cdf97", levels: int = 1,
         scheme: str = "ns-polyconv", optimize: bool = False,
         backend: str = "cuda", fuse: str = "none",
         boundary: str = "periodic", compute_dtype: str = "float32",
         tap_opt: str = "full", validate=None, device="cuda") -> Pyramid3:
    """Multi-level 3-D (t+2D) DWT of a (batch of) volume(s)
    ``(..., T, H, W)``.

    Each level lifts along the temporal axis (1-D periodic lifting of
    the wavelet's predict/update pairs, plain PyTorch —
    :mod:`repro_torch.compiler.temporal`) and transforms both temporal
    half-bands with the 2-D level of the chosen backend (the T/2 frames
    ride the leading batch dims; on "cuda", the window kernel's batch
    grid dimension); only the tL·LL subband recurses.  T, H and W must
    each be divisible by ``2**levels``.  On "cuda" the temporal pass
    runs unfused between the kernel launches (recorded on
    ``plan.fallback`` under ``fuse="levels"``).  ``fuse="pyramid"``
    demotes to ``"levels"``: the fused-pyramid kernels are
    2-D-pyramid-only.

    >>> import torch
    >>> from repro_torch import dwt3, idwt3
    >>> vid = torch.ones(8, 16, 16)           # T=8 frames of 16x16
    >>> p3 = dwt3(vid, wavelet="cdf53", levels=2, device="cpu")
    >>> p3.levels, tuple(p3.ll.shape)         # coarsest tLLL volume
    (2, (2, 4, 4))
    >>> [tuple(d[0].shape) for d in p3.details]   # 7 subbands/level
    [(2, 4, 4), (4, 8, 8)]
    >>> rec = idwt3(p3, wavelet="cdf53", device="cpu")
    >>> bool(torch.allclose(rec, vid, atol=1e-4))
    True
    """
    dev = _device(device)
    x = _on(x, dev)
    validate_finite(x, validate, what="dwt3 input")
    plan = _plan_for(x.shape, x.dtype, wavelet, levels, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, None,
                     dev, ndim=3)
    return plan.execute(x)


def idwt3(pyr: Pyramid3, wavelet: str = "cdf97",
          scheme: str = "ns-polyconv", optimize: bool = False,
          backend: str = "cuda", fuse: str = "none",
          boundary: str = "periodic", compute_dtype: str = "float32",
          tap_opt: str = "full", validate=None,
          device="cuda") -> torch.Tensor:
    """Inverse of :func:`dwt3` (pass the same ``wavelet`` / ``scheme``
    / backend arguments as the forward call).  The subbands are moved to
    ``device``."""
    dev = _device(device)
    pyr = Pyramid3(ll=_on(pyr.ll, dev),
                   details=[tuple(_on(d, dev) for d in det)
                            for det in pyr.details])
    validate_finite(pyr, validate, what="idwt3 input pyramid")
    ll = pyr.ll
    levels = pyr.levels
    shape = tuple(ll.shape[:-3]) + (ll.shape[-3] << levels,
                                    ll.shape[-2] << levels,
                                    ll.shape[-1] << levels)
    plan = _plan_for(shape, ll.dtype, wavelet, levels, scheme, optimize,
                     backend, fuse, boundary, compute_dtype, tap_opt, None,
                     dev, ndim=3)
    return plan.execute_inverse(pyr)


def flatten_pyramid(pyr: Pyramid) -> torch.Tensor:
    """Pack a pyramid back into a single (..., H, W) tensor (in-place
    subband layout, JPEG 2000 style: LL in the top-left corner)."""
    ll = pyr.ll
    for hl, lh, hh in pyr.details:
        top = torch.cat([ll, hl], dim=-1)
        bot = torch.cat([lh, hh], dim=-1)
        ll = torch.cat([top, bot], dim=-2)
    return ll


def unflatten_pyramid(x: torch.Tensor, levels: int) -> Pyramid:
    """Inverse of :func:`flatten_pyramid` (the subbands are views of
    ``x``)."""
    details: List[Detail] = []
    cur = x
    for _ in range(levels):
        h, w = cur.shape[-2] // 2, cur.shape[-1] // 2
        ll = cur[..., :h, :w]
        hl = cur[..., :h, w:]
        lh = cur[..., h:, :w]
        hh = cur[..., h:, w:]
        details.append((hl, lh, hh))
        cur = ll
    return Pyramid(cur, details[::-1])
