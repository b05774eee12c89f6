"""Async shape-bucketed request batching over the plan cache.

The batch dimension is a free leading dim on every registered backend,
so batching multiplies per-image throughput — yet every live caller
would pay its own dispatch.  :class:`DwtServer` closes the gap with a
front-end / device-worker split:

* a **front-end** (``submit`` / ``submit_inverse``) enqueues requests
  into shape buckets (:mod:`repro_torch.serve.bucket`) under bounded queue
  depth: when ``max_queue`` requests are in flight, new arrivals either
  wait (``backpressure="wait"``) or fail fast with
  :class:`QueueFullError` (``backpressure="reject"``);
* a **dispatcher** coalesces each bucket until it holds ``max_batch``
  requests or its oldest request has waited ``max_wait_ms``, then emits
  the batch — full buckets flush immediately, so the wait bound is the
  *worst-case* added latency, not a fixed tax;
* **N device workers** drain emitted batches: stack host-side, pad the
  batch dim to the bucket's plan size, execute ONE cached
  :class:`~repro_torch.engine.plan.DwtPlan`, and scatter per-request
  results back to their futures (zero-copy host views — no per-request
  device dispatch anywhere on the hot path);
* a **heartbeat tracker**
  (:class:`repro_torch.distributed.fault_tolerance.HeartbeatTracker`) follows
  worker liveness; when a worker dies its in-flight batch is
  re-dispatched to the surviving pool and — per the tracker's elastic
  restart decision — a replacement worker is spawned.

On the card (``ServeConfig.device``, default ``"cuda"``, resolved at
:meth:`DwtServer.start`: with no card a CUDA server raises and never
serves on the CPU) each worker owns one CUDA stream.  A batch is
stacked into a pinned host buffer of its worker (reused only after the
event of its last copy) and goes to the card in one ``non_blocking``
copy on that stream; the plan runs on that stream (its device spans and
kernels with it); every output comes back by one copy into pinned host
memory, then the worker waits on that stream's event — never a
device-wide synchronise — and each request gets numpy views of the
batch.  Nothing made on a worker stream is handed to another: the
device tables the plans' kernels read are uploaded by :meth:`warmup`
(:meth:`~repro_torch.engine.plan.DwtPlan.prepare`) before traffic.
float64 follows ``dwt2``: served on ``"torch"``/``"conv"``, refused on
``"cuda"`` (the batch fails with the ``BackendError`` naming
``PlanKey.dtype``).

Metrics (p50/p99 latency, served img/s, batch occupancy, backpressure
and re-dispatch counters) stream into :mod:`repro_torch.serve.metrics`
and surface through ``repro_torch.engine.stats()["serve"]``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.core.transform import validate_finite
from repro_torch.distributed.fault_tolerance import (FaultToleranceConfig,
                                                     HeartbeatTracker)
from repro_torch.engine.plan import resolve_device
from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D
from repro_torch.faults import inject as FI
from repro_torch.faults.policy import (CircuitBreaker, CircuitOpenError,
                                       DeadlineExceeded)
from repro_torch.serve import bucket as BK
from repro_torch.serve.metrics import METRICS


class QueueFullError(RuntimeError):
    """Raised by ``submit`` under ``backpressure="reject"`` when the
    server already holds ``max_queue`` in-flight requests."""


class WorkerDied(RuntimeError):
    """A device worker died (injected fault or unrecoverable crash);
    its in-flight batch is re-dispatched."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler knobs.

    ``max_batch``     — coalescing ceiling; also the largest padded
                        batch size plans are built for.
    ``max_wait_ms``   — how long a non-full bucket may age before it is
                        flushed (the worst-case latency the batcher may
                        add to a request).
    ``max_queue``     — bound on accepted-but-unfinished requests.
    ``backpressure``  — "wait" parks new submitters until capacity
                        frees; "reject" raises :class:`QueueFullError`.
    ``num_workers``   — device workers draining batches (each batch
                        executes in a worker thread so the event loop
                        keeps accepting traffic).
    ``max_redispatch``— how many dead-worker re-dispatches one request
                        survives before it fails.
    ``request_deadline_ms`` — per-request wall-clock budget (submit ->
                        result); a request still unresolved when it
                        expires fails with
                        :class:`~repro_torch.faults.policy.DeadlineExceeded`
                        instead of hanging on a stalled worker.  None
                        (default) keeps requests unbounded.
    ``breaker_threshold`` — per-bucket circuit breaker: after this many
                        *consecutive* batch failures the bucket opens
                        and requests fast-fail with
                        :class:`~repro_torch.faults.policy.CircuitOpenError`
                        for ``breaker_cooldown_s``, then a single
                        half-open probe decides (0 disables).
    ``validate``      — "nan" rejects NaN/Inf request payloads at
                        submit (:func:`repro_torch.core.transform
                        .validate_finite`); None (default) skips the
                        sweep.
    ``device``        — where batches run: ``"cuda"`` (the default) or
                        ``"cpu"``; resolved at ``start()`` (and by
                        ``warmup``), so a CUDA server with no card
                        raises.
    """

    max_batch: int = 16
    max_wait_ms: float = 2.0
    max_queue: int = 1024
    backpressure: str = "wait"
    num_workers: int = 2
    max_redispatch: int = 2
    soft_timeout_s: float = 1.0      # heartbeat: straggler threshold
    hard_timeout_s: float = 30.0     # heartbeat: dead threshold
    request_deadline_ms: Optional[float] = None
    breaker_threshold: int = 0       # 0 = breaker disabled
    breaker_cooldown_s: float = 1.0
    validate: Optional[str] = None   # "nan" = reject non-finite inputs
    device: str = "cuda"

    def __post_init__(self):
        if self.backpressure not in ("wait", "reject"):
            raise ValueError(f"backpressure must be 'wait' or 'reject', "
                             f"got {self.backpressure!r}")
        if self.max_batch < 1 or self.max_queue < 1 \
                or self.num_workers < 1:
            raise ValueError("max_batch, max_queue and num_workers must "
                             "be >= 1")
        if self.request_deadline_ms is not None \
                and self.request_deadline_ms <= 0:
            raise ValueError("request_deadline_ms must be positive "
                             "(or None to disable)")
        if self.validate not in (None, "nan"):
            raise ValueError(f"validate must be None or 'nan', "
                             f"got {self.validate!r}")


class DwtServer:
    """Asyncio serving runtime over the plan-cache engine.

    Use as an async context manager::

        async with DwtServer(ServeConfig(max_batch=16)) as srv:
            pyr = await srv.submit(img, scheme="ns-polyconv", levels=3)

    Results are host-side (numpy subbands): the scatter path copies each
    batched output to the host exactly once and hands out zero-copy
    views, so values are bitwise what the batched plan produced on the
    device.
    """

    def __init__(self, config: Optional[ServeConfig] = None):
        self.cfg = config or ServeConfig()
        self._running = False
        self._buckets: "OrderedDict[BK.BucketKey, deque]" = OrderedDict()
        self._buckets_seen: set = set()
        self._pending = 0
        self._worker_seq = 0
        self._in_flight: Dict[str, Tuple[BK.BucketKey, list]] = {}
        self._fail_next: set = set()
        self._breakers: Dict[BK.BucketKey, CircuitBreaker] = {}
        self._tasks: List[asyncio.Task] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.tracker: Optional[HeartbeatTracker] = None
        self._device: Optional[torch.device] = None
        # per worker (CUDA only): its stream, and its pinned staging
        # buffers by (numel, dtype) with the event of each one's last copy
        # (only the thread running the worker's one batch touches them)
        self._streams: Dict[str, "torch.cuda.Stream"] = {}
        self._stages: Dict[str, dict] = {}

    def _resolve_device(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device(self.cfg.device)
        return self._device

    # -- lifecycle -----------------------------------------------------
    async def start(self) -> "DwtServer":
        if self._running:
            return self
        self._resolve_device()
        self._loop = asyncio.get_running_loop()
        self._arrival = asyncio.Event()
        self._capacity = asyncio.Event()
        self._batch_q: asyncio.Queue = asyncio.Queue()
        self._pool = ThreadPoolExecutor(
            max_workers=self.cfg.num_workers,
            thread_name_prefix="dwt-serve")
        self.tracker = HeartbeatTracker(
            [], FaultToleranceConfig(
                soft_timeout_s=self.cfg.soft_timeout_s,
                hard_timeout_s=self.cfg.hard_timeout_s,
                quorum_fraction=0.5),
            clock=time.monotonic)
        self._running = True
        self._tasks = [self._loop.create_task(self._dispatch_loop(),
                                              name="dwt-serve-dispatch")]
        for _ in range(self.cfg.num_workers):
            self._spawn_worker(initial=True)
        return self

    def _spawn_worker(self, initial: bool = False) -> str:
        name = f"worker-{self._worker_seq}"
        self._worker_seq += 1
        self.tracker.register(name)
        if self._device.type == "cuda":
            self._streams[name] = torch.cuda.Stream(self._device)
            self._stages[name] = {}
        self._tasks.append(
            self._loop.create_task(self._run_worker(name), name=name))
        if not initial:
            METRICS.worker_spawned()
        return name

    def _retire(self, name: str) -> None:
        """Release a dead worker's stream and pinned staging buffers (its
        batch no longer runs: it died claiming it, or after it)."""
        self._streams.pop(name, None)
        self._stages.pop(name, None)

    async def stop(self, drain: bool = True) -> None:
        if not self._running:
            return
        if drain:
            while self._pending:
                self._flush_requested = True
                self._arrival.set()
                self._capacity.clear()
                if self._pending:
                    try:
                        await asyncio.wait_for(self._capacity.wait(), 0.1)
                    except asyncio.TimeoutError:
                        pass
        self._running = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        self._pool.shutdown(wait=False)
        self._streams.clear()
        self._stages.clear()

    async def __aenter__(self) -> "DwtServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc[0] is None)

    # -- front-end -----------------------------------------------------
    async def submit(self, x, *, wavelet: str = "cdf97",
                     scheme: str = "ns-polyconv", levels: int = 1,
                     backend: str = "cuda", optimize: bool = False,
                     fuse: str = "levels", boundary: str = "periodic",
                     compute_dtype: str = "float32",
                     tap_opt: str = "full") -> Pyramid:
        """Enqueue one forward transform of a single (H, W) image;
        resolves to the host-side :class:`Pyramid` once its bucket's
        batched plan execution scatters."""
        x = _host(x)
        validate_finite(x, self.cfg.validate, what="serve request")
        key = BK.request_key(
            x.shape, x.dtype, op="dwt2", wavelet=wavelet, scheme=scheme,
            levels=levels, backend=backend, optimize=optimize, fuse=fuse,
            boundary=boundary, compute_dtype=compute_dtype, tap_opt=tap_opt,
            device=str(self._device))
        return await self._submit(key, x)

    async def submit_inverse(self, pyr: Pyramid, *,
                             wavelet: str = "cdf97",
                             scheme: str = "ns-polyconv",
                             backend: str = "cuda",
                             optimize: bool = False,
                             fuse: str = "levels",
                             boundary: str = "periodic",
                             compute_dtype: str = "float32",
                             tap_opt: str = "full") -> np.ndarray:
        """Enqueue one inverse transform of a single-image pyramid;
        resolves to the reconstructed host-side (H, W) array."""
        host = Pyramid(ll=_host(pyr.ll),
                       details=[tuple(_host(d) for d in dd)
                                for dd in pyr.details])
        validate_finite(host, self.cfg.validate, what="serve request")
        levels = host.levels
        shape = (host.ll.shape[-2] << levels, host.ll.shape[-1] << levels)
        key = BK.request_key(
            shape, host.ll.dtype, op="idwt2", wavelet=wavelet,
            scheme=scheme, levels=levels, backend=backend,
            optimize=optimize, fuse=fuse, boundary=boundary,
            compute_dtype=compute_dtype, tap_opt=tap_opt,
            device=str(self._device))
        return await self._submit(key, host)

    async def submit_dwt3(self, x, *, wavelet: str = "cdf97",
                          scheme: str = "ns-polyconv", levels: int = 1,
                          backend: str = "cuda", optimize: bool = False,
                          fuse: str = "levels", boundary: str = "periodic",
                          compute_dtype: str = "float32",
                          tap_opt: str = "full") -> Pyramid3:
        """Enqueue one forward t+2D transform of a single (T, H, W)
        volume; resolves to the host-side :class:`Pyramid3`.  Volumes
        bucket on their full (T, H, W) geometry and batch onto the
        plan's free leading dim exactly like images."""
        x = _host(x)
        validate_finite(x, self.cfg.validate, what="serve request")
        key = BK.request_key(
            x.shape, x.dtype, op="dwt3", wavelet=wavelet, scheme=scheme,
            levels=levels, backend=backend, optimize=optimize, fuse=fuse,
            boundary=boundary, compute_dtype=compute_dtype, tap_opt=tap_opt,
            device=str(self._device))
        return await self._submit(key, x)

    async def submit_idwt3(self, pyr: Pyramid3, *,
                           wavelet: str = "cdf97",
                           scheme: str = "ns-polyconv",
                           backend: str = "cuda",
                           optimize: bool = False,
                           fuse: str = "levels",
                           boundary: str = "periodic",
                           compute_dtype: str = "float32",
                           tap_opt: str = "full") -> np.ndarray:
        """Enqueue one inverse t+2D transform of a single-volume
        :class:`Pyramid3`; resolves to the reconstructed host-side
        (T, H, W) array."""
        host = Pyramid3(ll=_host(pyr.ll),
                        details=[tuple(_host(d) for d in dd)
                                 for dd in pyr.details])
        validate_finite(host, self.cfg.validate, what="serve request")
        levels = host.levels
        shape = (host.ll.shape[-3] << levels,
                 host.ll.shape[-2] << levels,
                 host.ll.shape[-1] << levels)
        key = BK.request_key(
            shape, host.ll.dtype, op="idwt3", wavelet=wavelet,
            scheme=scheme, levels=levels, backend=backend,
            optimize=optimize, fuse=fuse, boundary=boundary,
            compute_dtype=compute_dtype, tap_opt=tap_opt,
            device=str(self._device))
        return await self._submit(key, host)

    async def submit_wpt2(self, x, *, packet="full:2",
                          wavelet: str = "cdf97",
                          scheme: str = "ns-polyconv",
                          backend: str = "cuda", optimize: bool = False,
                          fuse: str = "levels",
                          boundary: str = "periodic",
                          compute_dtype: str = "float32",
                          tap_opt: str = "full") -> WaveletPacket2D:
        """Enqueue one wavelet-packet transform of a single (H, W)
        image; resolves to the host-side :class:`WaveletPacket2D`.
        ``packet`` takes any :meth:`~repro_torch.core.packets
        .PacketTree.from_spec` spelling; equivalent spellings share one
        bucket (the key carries the canonical leaf tuple)."""
        x = _host(x)
        validate_finite(x, self.cfg.validate, what="serve request")
        key = BK.request_key(
            x.shape, x.dtype, op="wpt2", wavelet=wavelet, scheme=scheme,
            levels=1, backend=backend, optimize=optimize, fuse=fuse,
            boundary=boundary, compute_dtype=compute_dtype,
            tap_opt=tap_opt, packet=packet, device=str(self._device))
        return await self._submit(key, x)

    async def submit_iwpt2(self, pk: WaveletPacket2D, *,
                           wavelet: str = "cdf97",
                           scheme: str = "ns-polyconv",
                           backend: str = "cuda",
                           optimize: bool = False,
                           fuse: str = "levels",
                           boundary: str = "periodic",
                           compute_dtype: str = "float32",
                           tap_opt: str = "full") -> np.ndarray:
        """Enqueue one inverse packet transform of a single-image
        :class:`WaveletPacket2D`; resolves to the reconstructed
        host-side (H, W) array."""
        host = WaveletPacket2D(
            paths=tuple(pk.paths),
            leaves=[_host(leaf) for leaf in pk.leaves])
        validate_finite(host, self.cfg.validate, what="serve request")
        d0 = len(host.paths[0])
        shape = (host.leaves[0].shape[-2] << d0,
                 host.leaves[0].shape[-1] << d0)
        key = BK.request_key(
            shape, host.leaves[0].dtype, op="iwpt2", wavelet=wavelet,
            scheme=scheme, levels=1, backend=backend, optimize=optimize,
            fuse=fuse, boundary=boundary, compute_dtype=compute_dtype,
            tap_opt=tap_opt, packet=host.paths, device=str(self._device))
        return await self._submit(key, host)

    async def _submit(self, key: BK.BucketKey, payload):
        if not self._running:
            raise RuntimeError("DwtServer is not running; use "
                               "'async with DwtServer(...)' or await "
                               "server.start()")
        if self._pending >= self.cfg.max_queue:
            if self.cfg.backpressure == "reject":
                METRICS.request_rejected()
                raise QueueFullError(
                    f"{self._pending} requests in flight >= max_queue="
                    f"{self.cfg.max_queue} (backpressure='reject')")
            while self._pending >= self.cfg.max_queue:
                self._capacity.clear()
                await self._capacity.wait()
        self._pending += 1
        METRICS.request_submitted()
        fut = self._loop.create_future()
        req = BK.Request(payload=payload, future=fut, t=self._loop.time())
        with T.span("serve.enqueue", op=key.op, scheme=key.scheme,
                    backend=key.backend):
            self._buckets.setdefault(key, deque()).append(req)
            self._buckets_seen.add(key)
            self._arrival.set()
        try:
            if self.cfg.request_deadline_ms is None:
                return await fut
            try:
                return await asyncio.wait_for(
                    fut, self.cfg.request_deadline_ms / 1e3)
            except asyncio.TimeoutError:
                # wait_for cancelled the future, so a late batch result
                # is discarded (scatter checks future.done())
                METRICS.deadline_exceeded()
                raise DeadlineExceeded(
                    f"request exceeded its "
                    f"{self.cfg.request_deadline_ms:g} ms deadline "
                    f"(op={key.op}, bucket {key.h}x{key.w})") from None
        finally:
            self._pending -= 1
            self._capacity.set()

    def flush(self) -> None:
        """Force every non-empty bucket to dispatch now, ignoring the
        coalescing window (ops hook; also used on drain)."""
        self._flush_requested = True
        if self._running:
            self._arrival.set()

    # -- warmup --------------------------------------------------------
    def warmup(self, specs: Sequence[BK.BucketSpec],
               warm_profiler: bool = False, reps: int = 5,
               candidates=None) -> int:
        """Prefetch plans (and optionally profiler traces) for declared
        buckets so the first request of each is a plan-cache hit.

        Every padded batch size the bucket can execute at
        (:func:`repro_torch.serve.bucket.bucket_batches`) is resolved
        through ``repro_torch.engine.get_plan`` on the server's device,
        and each plan's kernels are built and device tables uploaded
        (:meth:`~repro_torch.engine.plan.DwtPlan.prepare`) before
        traffic.  With ``warm_profiler=True`` each batched shape is
        first measured into the profiler trace store
        (:func:`repro_torch.profiler.trace.warm_batches`) so
        ``backend="auto"`` buckets resolve from measurements instead of
        the cold-start rule; ``candidates`` narrows the measured
        ``(backend, fuse, tap_opt)`` sweep.  Returns the number of plans
        resolved."""
        from repro_torch import engine as E
        device = str(self._resolve_device())
        n = 0
        for spec in specs:
            for b in BK.bucket_batches(self.cfg.max_batch):
                if warm_profiler:
                    from repro_torch.profiler import warm_batches
                    warm_batches([b], spec.shape, wavelet=spec.wavelet,
                                 scheme=spec.scheme, levels=spec.levels,
                                 dtype=spec.dtype, optimize=spec.optimize,
                                 compute_dtype=spec.compute_dtype,
                                 reps=reps, candidates=candidates,
                                 device=device)
                # one plan serves both directions (the op is not in the
                # plan key)
                E.get_plan(**spec.key("dwt2", device).plan_kwargs(b)) \
                    .prepare()
                n += 1
        return n

    # -- dispatcher ----------------------------------------------------
    _flush_requested = False

    async def _dispatch_loop(self) -> None:
        max_wait_s = self.cfg.max_wait_ms / 1e3
        while True:
            now = self._loop.time()
            deadline = None
            flush = self._flush_requested
            self._flush_requested = False
            for key in list(self._buckets):
                dq = self._buckets[key]
                while len(dq) >= self.cfg.max_batch:
                    self._emit(key, [dq.popleft()
                                     for _ in range(self.cfg.max_batch)])
                if not dq:
                    del self._buckets[key]
                    continue
                due = dq[0].t + max_wait_s
                if flush or due <= now:
                    self._emit(key, [dq.popleft() for _ in range(len(dq))])
                    del self._buckets[key]
                else:
                    deadline = due if deadline is None \
                        else min(deadline, due)
            try:
                if deadline is None:
                    await self._arrival.wait()
                else:
                    await asyncio.wait_for(self._arrival.wait(),
                                           max(0.0, deadline - now))
            except asyncio.TimeoutError:
                pass
            self._arrival.clear()

    def _emit(self, key: BK.BucketKey, reqs: list) -> None:
        with T.span("serve.bucket_flush", op=key.op, scheme=key.scheme,
                    batch=len(reqs)):
            self._batch_q.put_nowait((key, reqs))

    # -- workers -------------------------------------------------------
    async def _run_worker(self, name: str) -> None:
        try:
            await self._worker_loop(name)
        except asyncio.CancelledError:
            raise
        except WorkerDied as e:
            self._on_worker_death(name, str(e))
        except Exception as e:
            # a non-fatal Python exception escaping the worker loop
            # itself (not batch execution — that path fails futures in
            # place): fail the claimed batch's futures with the real
            # exception instead of leaving its requests hanging, then
            # treat the worker as dead so the pool heals
            in_flight = self._in_flight.pop(name, None)
            if in_flight is not None:
                _, reqs = in_flight
                METRICS.request_failed(len(reqs))
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
            self.tracker.mark_dead(name)
            self._retire(name)
            METRICS.worker_died(redispatched=0)
            if self._running and self.tracker.should_restart_elastic():
                self._spawn_worker()

    def _breaker(self, key: BK.BucketKey) -> Optional[CircuitBreaker]:
        if self.cfg.breaker_threshold <= 0:
            return None
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = CircuitBreaker(
                self.cfg.breaker_threshold, self.cfg.breaker_cooldown_s)
        return br

    async def _worker_loop(self, name: str) -> None:
        idle_beat = max(0.05, self.cfg.soft_timeout_s / 2)
        step = 0
        while True:
            try:
                key, reqs = await asyncio.wait_for(self._batch_q.get(),
                                                   timeout=idle_beat)
            except asyncio.TimeoutError:
                self.tracker.beat(name, step)
                continue
            self.tracker.beat(name, step)
            self._in_flight[name] = (key, reqs)
            breaker = self._breaker(key)
            if breaker is not None and not breaker.allow():
                # bucket's circuit is open: fast-fail without burning a
                # worker thread on a config that keeps failing
                self._in_flight.pop(name, None)
                METRICS.breaker_rejected(len(reqs))
                METRICS.request_failed(len(reqs))
                err = CircuitOpenError(
                    f"circuit open for bucket {key.op} {key.h}x{key.w} "
                    f"({key.backend}/{key.fuse}) after repeated batch "
                    f"failures; retry after "
                    f"{self.cfg.breaker_cooldown_s:g}s cooldown")
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(err)
                continue
            if name in self._fail_next:
                self._fail_next.discard(name)
                raise WorkerDied(f"{name}: injected failure")
            try:
                outs, padded = await self._loop.run_in_executor(
                    self._pool, self._execute_batch, key, reqs, name)
            except Exception as e:
                # an execution error (bad geometry, backend reject, ...)
                # fails this batch's requests; the worker itself survives
                self._in_flight.pop(name, None)
                if breaker is not None:
                    breaker.record(ok=False)
                METRICS.request_failed(len(reqs))
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            # keep the batch in _in_flight until its futures are
            # resolved: an exception anywhere in this window (a metrics
            # hook, breaker bookkeeping) then escapes to _run_worker's
            # generic arm, which fails the claimed futures instead of
            # leaving the requests hanging forever
            if breaker is not None:
                breaker.record(ok=True)
            now = self._loop.time()
            METRICS.batch_done(real=len(reqs), padded=padded,
                               latencies_s=[now - r.t for r in reqs])
            for r, out in zip(reqs, outs):
                if not r.future.done():
                    r.future.set_result(out)
            self._in_flight.pop(name, None)
            step += 1
            self.tracker.beat(name, step)

    def _on_worker_death(self, name: str, reason: str) -> None:
        """Dead worker: re-dispatch its in-flight bucket to the
        surviving pool and, per the fault-tolerance decision function,
        spawn an elastic replacement."""
        self.tracker.mark_dead(name)
        self._retire(name)
        in_flight = self._in_flight.pop(name, None)
        survivors = []
        if in_flight is not None:
            key, reqs = in_flight
            for r in reqs:
                r.attempts += 1
                if r.attempts > self.cfg.max_redispatch:
                    METRICS.request_failed()
                    if not r.future.done():
                        r.future.set_exception(WorkerDied(
                            f"request dropped after {r.attempts} "
                            f"dispatch attempts ({reason})"))
                else:
                    survivors.append(r)
        METRICS.worker_died(redispatched=len(survivors))
        if survivors:
            if max(r.attempts for r in survivors) >= 2:
                # poison-batch quarantine: this batch has now killed
                # more than one worker, so one poisoned request is the
                # likely cause — re-dispatch survivors as isolated
                # singleton batches so the poison request exhausts its
                # own budget without cascading onto its batch-mates
                METRICS.quarantined(len(survivors))
                for r in survivors:
                    self._batch_q.put_nowait((key, [r]))
            else:
                self._batch_q.put_nowait((key, survivors))
        if self._running and self.tracker.should_restart_elastic():
            self._spawn_worker()

    def inject_worker_failure(self, name: Optional[str] = None) -> str:
        """Test/ops hook: make one worker die when it next claims a
        batch (its in-flight requests must be re-dispatched and served
        by the surviving pool)."""
        if name is None:
            name = next(n for n in self.tracker.hosts
                        if n not in self.tracker.dead())
        self._fail_next.add(name)
        return name

    # -- batched execution (worker thread) ----------------------------
    def _execute_batch(self, key: BK.BucketKey, reqs: list,
                       worker: Optional[str] = None):
        from repro_torch import engine as E
        n = len(reqs)
        b = BK.padded_batch(n, self.cfg.max_batch)
        stream = self._streams.get(worker)
        with T.span("serve.batch", op=key.op, scheme=key.scheme,
                    real=n, padded=b):
            FI.maybe_inject("serve.batch", op=key.op, batch=b)
            plan = E.get_plan(**key.plan_kwargs(b))
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                with T.span("serve.stack_h2d", op=key.op, batch=b):
                    FI.maybe_inject("serve.stack_h2d", op=key.op)
                    batch = self._stack_h2d(worker, reqs, b, stream)
                with T.span("serve.execute", op=key.op, batch=b,
                            backend=plan.key.backend):
                    if key.op in ("dwt2", "dwt3", "wpt2"):
                        out = plan.execute(batch)
                    else:
                        out = plan.execute_inverse(batch)
                with T.span("serve.scatter", op=key.op, batch=b):
                    return BK.scatter_tree(self._to_host(out, stream), n), b

    def _stack_h2d(self, worker, reqs: list, b: int, stream):
        """The batch's requests stacked (zero-padded to ``b``) onto the
        server's device: on the CPU as tensors over the stacked arrays;
        on the card through the worker's pinned staging buffer, in one
        ``non_blocking`` copy on its stream."""
        payloads = [r.payload for r in reqs]
        if stream is None:
            host = BK.stack_trees(payloads, b)
            return BK.unflatten_tree(host, [torch.from_numpy(a) for a in
                                            BK.flatten_tree(host)])
        dtype = BK.flatten_tree(payloads[0])[0].dtype
        stage, copied = self._stage(worker, BK.stacked_numel(payloads[0], b),
                                    dtype)
        copied.synchronize()        # its last copy has left the buffer
        host = BK.stack_trees(payloads, b, out=stage.numpy())
        flat = stage.to(self._device, non_blocking=True)
        copied.record(stream)
        leaves = BK.flatten_tree(host)
        return BK.unflatten_tree(host, BK.split_flat(
            flat, [leaf.shape for leaf in leaves]))

    def _stage(self, worker, numel: int, dtype):
        """The worker's pinned staging buffer of ``numel`` elements of
        ``dtype`` and the event of its last copy (made at first use)."""
        tdt = torch.from_numpy(np.empty(0, dtype)).dtype
        stages = self._stages[worker]
        entry = stages.get((numel, tdt))
        if entry is None:
            entry = stages[(numel, tdt)] = (
                torch.empty(numel, dtype=tdt, pin_memory=True),
                torch.cuda.Event())
        return entry

    def _to_host(self, out, stream):
        """The batch's outputs as a host tree of numpy arrays: on the
        card one copy per output tensor into one pinned buffer of this
        batch (the requests' views keep it alive), then a wait on the
        worker stream's event."""
        leaves = BK.flatten_tree(out)
        if stream is None:
            return BK.unflatten_tree(out, [t.numpy() for t in leaves])
        flat = torch.empty(sum(t.numel() for t in leaves),
                           dtype=leaves[0].dtype, pin_memory=True)
        views = BK.split_flat(flat, [t.shape for t in leaves])
        for v, t in zip(views, leaves):
            v.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        return BK.unflatten_tree(out, [v.numpy() for v in views])

    # -- observability -------------------------------------------------
    def stats(self) -> dict:
        """Instance-level view (the process-wide counters live in
        ``repro_torch.engine.stats()["serve"]``): queue depths, bucket
        population, and worker liveness from the heartbeat tracker."""
        workers = {"alive": [], "stragglers": [], "dead": []}
        if self.tracker is not None:
            dead = set(self.tracker.dead())
            strag = set(self.tracker.stragglers())
            for h in self.tracker.hosts:
                workers["dead" if h in dead else
                        "stragglers" if h in strag else "alive"].append(h)
        return {
            "running": self._running,
            "pending": self._pending,
            "queued_batches": (self._batch_q.qsize()
                               if self._running else 0),
            "open_buckets": len(self._buckets),
            "buckets_seen": len(self._buckets_seen),
            "workers": workers,
        }


def serve_map(inputs, *, config: Optional[ServeConfig] = None,
              concurrency: int = 16, warmup=None, **transform_kw):
    """Convenience front door for scripts and examples: serve every
    array in ``inputs`` through one :class:`DwtServer` with at most
    ``concurrency`` requests in flight, returning the per-input
    pyramids in order.  ``warmup`` optionally passes
    :class:`~repro_torch.serve.bucket.BucketSpec` s to prefetch before
    traffic starts.  (Real deployments keep a long-lived server; this
    spins one up around a single wave of traffic.)"""
    async def _run():
        srv = DwtServer(config)
        if warmup:
            srv.warmup(warmup)
        async with srv:
            sem = asyncio.Semaphore(concurrency)

            async def one(x):
                async with sem:
                    return await srv.submit(x, **transform_kw)
            return await asyncio.gather(*[one(x) for x in inputs])
    return asyncio.run(_run())


def _host(x) -> np.ndarray:
    """A request payload as a host numpy array (a tensor is copied off
    its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
