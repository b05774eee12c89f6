"""The reversible lifting kernel (RL): one level of the 2-D reversible
integer wavelet of ISO/IEC 15444-1 Annex F in one launch per direction.

Replaces no kernel of the reference package, which has no integer path.
The CUDA source is ``repro_torch/csrc/rev_lift.cu``; this module builds
it with ``nvcc`` at first use (:class:`~repro_torch.kernels.tap_window.
KernelLibrary`, with the device functions of ``window_common.cuh``),
launches it through ``ctypes`` and keeps its plain version,
:func:`repro_torch.core.reversible.level_forward` / ``level_inverse``.

What bounds it on an H100: device-memory bytes.  A level reads every
sample once and writes it once, with a few integer adds and shifts per
sample.  What the design does about it (details in the source):

* a block stages one tile's window (32 x 64 output pairs, the level's
  interleaved samples or its four subbands, with the 5-3's halo) in
  shared memory through ``cp.async``, runs Annex F's two 1-D passes
  there in its order (columns then rows forward, rows then columns
  back) and writes its tile once: the forward writes the four subbands
  as planar tensors, the inverse the interleaved level, so no split or
  merge is a copy of its own;
* the symmetric extension is in the index (the mirrored sample is
  loaded), which is exact for every intermediate signal of both passes.

Integer adds and arithmetic shifts, in the plain version's order: the
two agree bit for bit by construction.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import reversible as RV
from repro_torch.kernels import tap_window as TW

SOURCE = TW.CSRC / "rev_lift.cu"


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rev_lift_launch.argtypes = [i] + [p] * 5 + [i] * 7 + [p, p]
    lib.rev_lift_launch.restype = i


LIBRARY = TW.KernelLibrary(SOURCE, _bind)
KERNEL = TW.Kernel("rev_lift", LIBRARY)


def _images(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as contiguous ``(B, h, w)`` int32 images on its device."""
    if t.dtype != RV.DTYPE:
        raise TypeError(f"rev_lift transforms {RV.DTYPE} samples, got "
                        f"{what} of {t.dtype}")
    if t.dim() < 2:
        raise ValueError(f"rev_lift {what} must be (..., H, W), got "
                         f"{tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"rev_lift runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def _launch(inverse: bool, x: torch.Tensor, bands, wavelet: str) -> None:
    b, h, w = x.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"rev_lift: a {h}x{w} image exceeds the kernel's "
                         f"int32 indexing")
    wv = RV.get_reversible(wavelet)
    lib = KERNEL.library()
    info = (ctypes.c_int * 2)()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rev_lift_launch(
            int(inverse), x.data_ptr(), *[t.data_ptr() for t in bands], b,
            h, w, wv.predict_shift, wv.update_shift, wv.update_round,
            dev.index, stream, info)
    LIBRARY.check(err, "rev_lift")
    KERNEL.launched(info)


def rev_lift_forward(x: torch.Tensor, wavelet: str = "rev53"
                     ) -> Tuple[torch.Tensor, ...]:
    """One forward level of int32 images ``(..., H, W)``: ``(LL, HL, LH,
    HH)``, each ``(..., H/2, W/2)``, as
    :func:`~repro_torch.core.reversible.level_forward`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (and count one launch) or raise."""
    if x.device.type == "cpu":
        return RV.level_forward(x, wavelet)
    *lead, h, w = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"rev_lift needs even H and W, got {h}x{w}")
    x3 = _images(x, "input")
    bands = tuple(torch.empty((x3.shape[0], h // 2, w // 2),
                              dtype=x.dtype, device=x.device)
                  for _ in range(4))
    if x3.numel():
        _launch(False, x3, bands, wavelet)
    return tuple(t.reshape(tuple(lead) + t.shape[-2:]) for t in bands)


def rev_lift_inverse(planes, wavelet: str = "rev53") -> torch.Tensor:
    """Inverse of :func:`rev_lift_forward`: ``(LL, HL, LH, HH)`` -> the
    int32 images ``(..., H, W)``.  CPU tensors run the plain version."""
    if all(t.device.type == "cpu" for t in planes):
        return RV.level_inverse(planes, wavelet)
    ll = planes[0]
    for t in planes[1:]:
        if t.shape != ll.shape or t.dtype != ll.dtype \
                or t.device != ll.device:
            raise ValueError(
                f"rev_lift subbands disagree: {tuple(t.shape)} {t.dtype} "
                f"{t.device} vs {tuple(ll.shape)} {ll.dtype} {ll.device}")
    bands = tuple(_images(t, band)
                  for t, band in zip(planes, ("LL", "HL", "LH", "HH")))
    *lead, hp, wp = ll.shape
    x = torch.empty((bands[0].shape[0], 2 * hp, 2 * wp), dtype=ll.dtype,
                    device=ll.device)
    if x.numel():
        _launch(True, x, bands, wavelet)
    return x.reshape(tuple(lead) + x.shape[-2:])
