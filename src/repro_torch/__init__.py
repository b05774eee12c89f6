"""PyTorch/CUDA port of the multi-level DWT engine.

The same plan cache, scheme algebra and tap-program compiler as the
reference package, executed by a torch reference backend (``"torch"``),
by hand-written CUDA kernels (``"cuda"``,
:mod:`repro_torch.kernels.tap_window`) and by grouped ``F.conv2d`` calls
(``"conv"``).  The 2-D pyramid (``dwt2``/``idwt2``), wavelet packets
(``wpt2``/``iwpt2``/``best_basis``) and the t+2D volume transform
(``dwt3``/``idwt3``) run on every backend, monolithic or over a grid of
halo-padded tiles (``tiles=``, ``dwt2_tiled``/``idwt2_tiled``); images
larger than the card stream band by band from host memory
(``stream_dwt2``).  ``backend="auto"`` picks the backend and fuse mode
from measurements (:mod:`repro_torch.profiler`), and
:class:`~repro_torch.serve.DwtServer` batches concurrent requests onto
cached plans (:mod:`repro_torch.serve`).  Gradient compression
(:mod:`repro_torch.core.compression`) runs the transform inside the
training step of the dense and VLM language models
(:mod:`repro_torch.runtime.train_loop`).  Entry points run on the card
unless the caller passes ``device="cpu"``.

    >>> import torch, repro_torch
    >>> pyr = repro_torch.dwt2(torch.ones(16, 16), levels=2, device="cpu")
    >>> tuple(pyr.ll.shape)
    (4, 4)
"""
from repro_torch.core.packets import PacketTree
from repro_torch.core.transform import (best_basis, dwt2, dwt3,
                                        flatten_pyramid, idwt2, idwt3,
                                        iwpt2, unflatten_pyramid,
                                        validate_finite, wpt2)
from repro_torch.engine import (BackendError, DwtPlan, PlanCache, PlanKey,
                                Pyramid, Pyramid3, WaveletPacket2D,
                                available_backends, clear_plan_cache,
                                get_plan, plan_cache_stats)
from repro_torch.profiler import (AutoChoice, CostModel, TraceRecord,
                                  TraceStore, choose, profile_plan,
                                  warm_batches, warm_store)
from repro_torch.serve import (BucketSpec, DwtServer, ServeConfig,
                               serve_map)
from repro_torch.tiling import dwt2_tiled, idwt2_tiled, stream_dwt2

__all__ = ["AutoChoice", "BackendError", "BucketSpec", "CostModel",
           "DwtPlan", "DwtServer", "PacketTree", "PlanCache", "PlanKey",
           "Pyramid", "Pyramid3", "ServeConfig", "TraceRecord", "TraceStore",
           "WaveletPacket2D", "available_backends", "best_basis", "choose",
           "clear_plan_cache", "dwt2", "dwt2_tiled", "dwt3",
           "flatten_pyramid", "get_plan", "idwt2", "idwt2_tiled", "idwt3",
           "iwpt2", "plan_cache_stats", "profile_plan", "serve_map",
           "stream_dwt2", "unflatten_pyramid", "validate_finite",
           "warm_batches", "warm_store", "wpt2"]
