"""Streaming executor: out-of-core images, fed tile-row band by band.

The gather transport needs the whole image on the device; this module
lifts that ceiling.  The image stays in *host* memory (anything with
numpy fancy-indexing — an ``np.ndarray``, an ``np.memmap`` over a file
larger than device memory), and tiles flow through the device one
tile-row **band** at a time:

    host gather (band i+1)  |  h2d copy (band i+1)  |  compute (band i)
                            |  d2h copy (band i-1)  |

On a CUDA device the three device stages run on three streams: the h2d
copies on a copy stream, the band transform on the caller's current
stream, the d2h copies of each band's output rows on a drain stream,
chained by CUDA events.  Each band gathers its tile windows on the host
straight into a pinned staging buffer; a ring of ``max_inflight + 1``
slots (pinned staging buffer, pinned output rows and their events) and
two device windows let band i+1 be gathered and copied while band i
computes.  A buffer is refilled only after the event of its previous
use has fired (the host waits for a staging buffer's h2d copy, the copy
stream for a device window's transform), so no buffer is overwritten
while a copy or kernel still reads it.  At most ``max_inflight`` bands of output are outstanding
before the oldest is drained: the host waits for that band's d2h event
and writes its rows of every pyramid level into preallocated host
arrays, so the pyramid materializes incrementally, top to bottom, and
device memory stays ``O(max_inflight * band)`` regardless of image size.
Nothing in the loop synchronises the device (no ``.cpu()``, ``.item()``
or ``torch.cuda.synchronize()``).  On the CPU the same loop runs
synchronously.

Every band runs the same batched window plan the in-core gather
transport uses (tiles on the kernels' batch grid dimension), so the
streamed pyramid matches ``dwt2_tiled`` — and the monolithic ``dwt2`` —
bit for bit, without the image ever existing on the device.

float64 images run on the ``"torch"`` and ``"conv"`` backends (computed
at ``compute_dtype``, returned as float64, as ``dwt2`` does); on
``"cuda"`` the plan build raises
:class:`~repro_torch.engine.backends.BackendError` naming
``PlanKey.dtype``, as ``dwt2`` does.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.engine.pyramid import Pyramid
from repro_torch.faults import degrade as DG
from repro_torch.faults import inject as FI
from repro_torch.faults.policy import RETRIES, retry_call
from repro_torch.tiling import exchange as EX


def _host_band(image, ri_band: np.ndarray, ci: np.ndarray,
               out: np.ndarray) -> None:
    """Gather one band's tile windows on host into ``out`` (a pinned
    staging buffer, ``(n_cols, wh, ww)``): rows ``ri_band`` (one wrapped
    read of ``wh`` full-width rows), then per-tile column windows.
    Works on any numpy-indexable image."""
    rows = np.asarray(image[ri_band])           # (wh, W)
    # (wh, nc, ww) view of the (nc, wh, ww) buffer: one pass, no temporary
    np.take(rows, ci, axis=1, out=out.transpose(1, 0, 2), mode="clip")


class _Slot:
    """One stage of the band pipeline: the pinned staging buffer of a
    band's windows, the pinned host rows of its output planes, and the
    events that order their reuse (CUDA only)."""

    def __init__(self, win_shape: Tuple[int, ...],
                 out_shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
                 cuda: bool):
        self.stage = torch.empty(win_shape, dtype=dtype, pin_memory=cuda)
        self.out = [torch.empty(s, dtype=dtype, pin_memory=cuda)
                    for s in out_shapes]
        if cuda:
            self.h2d_done = torch.cuda.Event()
            self.compute_done = torch.cuda.Event()
            self.d2h_done = torch.cuda.Event()


def _take_slots(plan, n: int, win_shape, out_shapes, dtype, cuda
                ) -> List[_Slot]:
    """``n`` idle slots of the tiled plan's pool (made when missing):
    pinned host memory is slow to allocate, so streams of one
    configuration reuse it; concurrent streams take distinct slots."""
    pool = plan.__dict__.setdefault("_stream_slots", [])
    got = []
    while pool and len(got) < n:
        try:
            got.append(pool.pop())
        except IndexError:          # another stream took the last one
            break
    while len(got) < n:
        got.append(_Slot(win_shape, out_shapes, dtype, cuda))
    return got


def stream_dwt2(image, *, wavelet: str = "cdf97", levels: int = 1,
                scheme: str = "ns-polyconv",
                tiles: Tuple[int, int] = (256, 256),
                optimize: bool = False, backend: str = "cuda",
                fuse: str = "levels", boundary: str = "periodic",
                compute_dtype: str = "float32", tap_opt: str = "full",
                max_inflight: int = 2, checkpoint: Optional[str] = None,
                retries: int = 0, device="cuda") -> Pyramid:
    """Multi-level forward DWT of a host-resident (H, W) image, streamed
    band by band; returns a host (numpy) :class:`Pyramid`.

    ``image`` is anything numpy can fancy-index — an ``np.ndarray`` or an
    ``np.memmap`` over a file larger than device memory; at most
    ``max_inflight`` tile-row bands of output are in flight on the
    device (``device="cuda"``, the default, or ``"cpu"``).

    ``checkpoint`` names a directory for the journaled band checkpoint
    (:mod:`repro_torch.tiling.checkpoint`): the pyramid materializes into
    memmaps there and every completed band is recorded in a fsync'd
    write-ahead journal, so a killed run resumes by passing the same
    directory — already-journaled bands are skipped and the returned
    pyramid is backed by the checkpoint's memmaps.  The configuration
    is pinned in the checkpoint manifest; resuming with different
    parameters raises
    :class:`~repro_torch.tiling.checkpoint.CheckpointMismatch`.

    ``retries`` > 0 re-attempts a failed band that many times before
    giving up (a failed drain recomputes the band from host data, since
    its in-flight device buffers may be poisoned).  On the card and on
    the ``"cuda"`` backend only the fault plane's own errors are retried
    (:data:`repro_torch.faults.degrade.PLANE_ERRORS`); any other error —
    a CUDA error, out of memory, a kernel that fails to build or load —
    propagates as it is.

    >>> import numpy as np
    >>> from repro_torch import dwt2, stream_dwt2
    >>> img = np.arange(64.0 * 64, dtype=np.float32).reshape(64, 64)
    >>> pyr = stream_dwt2(img, wavelet="cdf97", levels=2, tiles=(32, 32),
    ...                   backend="torch", device="cpu")
    >>> type(pyr.ll).__name__, pyr.ll.shape      # host-resident result
    ('ndarray', (16, 16))
    >>> mono = dwt2(img, levels=2, backend="torch", device="cpu")
    >>> bool(np.array_equal(pyr.ll, mono.ll.numpy()))
    True
    """
    from repro_torch import engine as E  # deferred: engine <-> tiling cycle
    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if len(image.shape) != 2:
        raise ValueError(
            f"stream_dwt2 streams single (H, W) images, got {image.shape}")
    h, w = int(image.shape[-2]), int(image.shape[-1])
    dtype = np.dtype(image.dtype)
    dev = E.resolve_device(device)
    cuda = dev.type == "cuda"
    # the tiled plan resolves (and caches) the grid geometry; its batched
    # gather executor is not used here — bands run a window plan of their
    # own, one tile row stacked on the batch axis
    common = dict(wavelet=wavelet, scheme=scheme, levels=levels,
                  dtype=str(dtype), backend=backend, optimize=optimize,
                  fuse=fuse, boundary=boundary, compute_dtype=compute_dtype,
                  tap_opt=tap_opt, device=dev)
    plan = E.get_plan(shape=(h, w), tiles=tiles, **common)
    grid = plan.grid
    (th, tw), (nr, nc) = grid.tile, grid.grid_shape
    wh, ww = grid.window_shape
    wplan = E.get_plan(shape=(nc, wh, ww), **common)
    ri = EX.window_indices(nr, th, grid.margin, h)
    ci = EX.window_indices(nc, tw, grid.margin, w)
    # each output plane's rows of one band, coarsest LL first, then the
    # details coarsest-first (the engine's order)
    plane_levels = [levels - 1] + [levels - 1 - k for k in range(levels)
                                   for _ in range(3)]
    out_shapes = [(th >> (lvl + 1), w >> (lvl + 1)) for lvl in plane_levels]

    # the band executor is cached on the (plan-cache-resident) tiled plan:
    # repeated streams of same-config images re-use it
    band = plan.__dict__.get("_stream_band")
    if band is None:
        def band_fn(wins):
            """One band: (nc, wh, ww) windows -> each output plane's rows
            of the band, (ch, W_l) contiguous, in ``plane_levels`` order."""
            wll, wdetails = wplan.run("forward", wins)
            planes = [wll] + [d for det in wdetails for d in det]
            rows = []
            for t, lvl in zip(planes, plane_levels):
                c = EX.extract_core(t, grid, lvl)           # (nc, ch, cw)
                ch, cw = c.shape[-2:]
                rows.append(c.transpose(0, 1).reshape(ch, nc * cw)
                            [:, :w >> (lvl + 1)].contiguous())
            return rows

        band = plan._stream_band = band_fn

    # preallocated host pyramid (coarsest-first details, like the engine);
    # with a checkpoint the planes are directory-backed memmaps instead
    ckpt = None
    done: set = set()
    if checkpoint is not None:
        from repro_torch.tiling import checkpoint as CK
        ckpt = CK.open_checkpoint(checkpoint, {
            "wavelet": wavelet, "scheme": scheme, "levels": levels,
            "tiles": list(tiles), "optimize": bool(optimize),
            "backend": backend, "fuse": fuse, "boundary": boundary,
            "compute_dtype": compute_dtype, "tap_opt": tap_opt,
            "h": h, "w": w, "dtype": str(dtype), "nr": nr})
        ll_out, det_out = ckpt.ll, ckpt.details
        done = set(ckpt.completed)
    else:
        f_top = 1 << levels
        ll_out = np.empty((h // f_top, w // f_top), dtype)
        det_out = [tuple(np.empty((h >> (lvl + 1), w >> (lvl + 1)), dtype)
                         for _ in range(3))
                   for lvl in [levels - 1 - k for k in range(levels)]]
    dsts = [ll_out] + [p for det in det_out for p in det]

    nslots = max_inflight + 1
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    slots = _take_slots(plan, nslots, (nc, wh, ww), out_shapes, tdtype,
                        cuda)
    if cuda:
        compute = torch.cuda.current_stream(dev)
        h2d = torch.cuda.Stream(dev)
        d2h = torch.cuda.Stream(dev)
        # two device windows, allocated on the compute stream: band i+1 is
        # copied into one while band i computes on the other, and the copy
        # stream overwrites a window only after the compute stream's event
        # says the band before has read it
        windows = [torch.empty((nc, wh, ww), dtype=tdtype, device=dev)
                   for _ in range(2)]
        window_read = [torch.cuda.Event() for _ in range(2)]

    def produce(i):
        """Gather + dispatch one band (the recomputable unit); returns
        its output rows (host tensors on the CPU, in flight on the
        card)."""
        k = i % nslots
        slot = slots[k]
        with T.span("stream.host_gather", band=i):
            FI.maybe_inject("stream.host_gather", band=i)
            if cuda:
                slot.h2d_done.synchronize()   # its last h2d has read it
            _host_band(image, ri[i], ci, slot.stage.numpy())
        with T.span("stream.h2d_dispatch", band=i):
            FI.maybe_inject("stream.h2d_dispatch", band=i)
            if not cuda:
                return band(slot.stage)
            win, read = windows[i % 2], window_read[i % 2]
            with torch.cuda.stream(h2d):
                h2d.wait_event(read)
                win.copy_(slot.stage, non_blocking=True)
                slot.h2d_done.record(h2d)
            compute.wait_event(slot.h2d_done)
            rows = band(win)
            read.record(compute)
            slot.compute_done.record(compute)
            with torch.cuda.stream(d2h):
                d2h.wait_event(slot.compute_done)
                for host, r in zip(slot.out, rows):
                    host.copy_(r, non_blocking=True)
                    r.record_stream(d2h)    # freed once the copy is done
                slot.d2h_done.record(d2h)
            return slot.out

    strict = DG._strict(plan.key)
    retry_on = DG.PLANE_ERRORS if strict else (Exception,)

    def produce_r(i):
        if retries > 0:
            return retry_call(lambda: produce(i), site="stream.band",
                              retries=retries, retry_on=retry_on)
        return produce(i)

    def write_rows(i, rows) -> None:
        if cuda:
            slots[i % nslots].d2h_done.synchronize()
        for dst, lvl, r in zip(dsts, plane_levels, rows):
            ch = th >> (lvl + 1)
            r0 = i * ch
            r1 = min(r0 + ch, h >> (lvl + 1))
            dst[r0:r1] = r.numpy()[:r1 - r0]

    def drain_one(item) -> None:
        """Drain one band, retrying by *recomputing* it — a failed
        drain's in-flight device buffers may carry the failure — then
        durably journal it when checkpointing."""
        i = item[0]
        attempts = 0
        while True:
            try:
                with T.span("stream.drain", band=i):
                    FI.maybe_inject("stream.drain", band=i)
                    write_rows(*item)
                break
            except retry_on:
                if attempts >= retries:
                    raise
                attempts += 1
                RETRIES.inc(site="stream.drain")
                item = (i, produce_r(i))
        if ckpt is not None:
            ckpt.commit_band(i)

    # under REPRO_TORCH_TELEMETRY=spans the three pipeline stages time
    # separately on the host: the gather, the h2d + dispatch, and the
    # blocking drain (device work the overlap did not hide)
    pending = deque()
    with T.span("stream.dwt2", bands=nr, levels=levels, backend=backend):
        for i in range(nr):
            if i in done:       # journaled by an earlier (killed) run
                continue
            pending.append((i, produce_r(i)))
            while len(pending) > max_inflight:
                drain_one(pending.popleft())
        while pending:
            drain_one(pending.popleft())
    # every band drained: no copy reads or writes a slot any more, so the
    # slots go back to the pool (after an error they are dropped instead,
    # copies perhaps still in flight)
    plan._stream_slots.extend(slots)
    return Pyramid(ll=ll_out, details=det_out)
