"""Per-plan execution tracer: measure a plan, persist a trace record.

:func:`measure_plan` times one built plan at steady state: on a CUDA
device it first builds the plan's kernels and uploads its device tables
(:meth:`~repro_torch.engine.plan.DwtPlan.prepare`), so an ``nvcc`` build
never enters a record, then runs one warm-up execution and ``reps``
timed executions, each bracketed by ``torch.cuda.synchronize()`` and
``time.perf_counter()`` (wall time per call, the reference's
``block_until_ready``), and takes the median; on the CPU
``perf_counter`` alone.  :func:`profile_plan` pairs the time with the
plan's cost-model features (:func:`repro_torch.profiler.model
.config_features`) and appends the
:class:`~repro_torch.profiler.store.TraceRecord` to the store.

:func:`warm_store` measures every valid ``(backend, fuse)`` candidate
of one configuration so ``backend="auto"`` resolves from measurements
instead of the cold-start rule; :func:`warm_batches` does it for every
padded batch size of a serving bucket.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional

from repro_torch.profiler import model as M
from repro_torch.profiler import store as ST


def _input(plan):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(plan.key.shape))
    return x.to(device=plan.key.device, dtype=getattr(torch, plan.key.dtype))


def measure_times(plan, x=None, reps: int = 5) -> List[float]:
    """Seconds of each of ``reps`` timed ``plan.execute`` calls, taken
    back to back after the kernels are built, the tables uploaded and one
    warm-up execution."""
    import torch
    if x is None:
        x = _input(plan)
    cuda = x.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    plan.prepare()
    plan.execute(x)
    sync()
    ts = []
    for _ in range(max(1, reps)):
        sync()
        t0 = time.perf_counter()
        plan.execute(x)
        sync()
        ts.append(time.perf_counter() - t0)
    return ts


def measure_plan(plan, x=None, reps: int = 5) -> float:
    """Median seconds per ``plan.execute`` (see :func:`measure_times`)."""
    return statistics.median(measure_times(plan, x=x, reps=reps))


def profile_plan(plan, x=None, reps: int = 5,
                 store: Optional[ST.TraceStore] = None,
                 block=None, record: bool = True) -> ST.TraceRecord:
    """Measure one plan and (by default) persist the trace.

    ``block`` annotates the block target the plan was built with (a
    block sweep passes each candidate); when omitted, the plan's own
    target is recorded: its block-table entry or the default on the
    window-kernel backend, None elsewhere.  The record's ``meta`` holds
    the runtime (:func:`~repro_torch.profiler.store.runtime_meta`), the
    plan's own launch count and the spread of the timed calls
    (``(max - min) / median``).  Pass ``record=False`` to measure
    without touching the store.
    """
    from repro_torch import telemetry as T
    from repro_torch.engine import plan as P
    key = plan.key
    ts = measure_times(plan, x=x, reps=reps)
    t = statistics.median(ts)
    T.record_execution(plan, t, op="profile")
    if block is None and plan.backend.window_kernel:
        block = P.pick_block_target(key)
    feats = M.config_features(key, block=block)
    rec = ST.record_from_key(
        key, block, t, feats["hbm_bytes"], feats["launches"],
        meta={"plan_launches": plan.launches,
              "reps": len(ts), "spread": (max(ts) - min(ts)) / t,
              **ST.runtime_meta(key.device)})
    if record:
        (store if store is not None else ST.TraceStore()).append(rec)
    return rec


def warm_store(shape=(1, 64, 64), wavelet: str = "cdf97",
               scheme: str = "ns-polyconv", levels: int = 2,
               dtype: str = "float32", optimize: bool = False,
               compute_dtype: str = "float32", reps: int = 5,
               store: Optional[ST.TraceStore] = None,
               candidates=None, device="cuda") -> List[ST.TraceRecord]:
    """Measure every valid ``(backend, fuse, tap_opt)`` candidate of one
    configuration on ``device`` and append the traces to the store;
    returns the new records.  Plans are built directly (bypassing the
    plan cache) so a warmed process state never skews the measurements."""
    from repro_torch import engine as E
    from repro_torch.profiler import auto as A
    key = E.canonical_key(E.PlanKey(
        wavelet=wavelet, scheme=scheme, levels=int(levels),
        shape=tuple(int(d) for d in shape), dtype=dtype, backend="auto",
        optimize=bool(optimize), fuse="none", boundary="periodic",
        compute_dtype=compute_dtype, tap_opt="full", device=str(device)))
    if candidates is None:
        candidates = A.enumerate_candidates(key)
    if store is None:
        store = ST.TraceStore()
    records = []
    for backend, fuse, tap_opt in candidates:
        concrete = dataclasses.replace(key, backend=backend, fuse=fuse,
                                       tap_opt=tap_opt)
        plan = E.build_plan(concrete)
        records.append(profile_plan(plan, reps=reps, store=store))
    return records


def warm_batches(batches, shape_hw, **kwargs) -> List[ST.TraceRecord]:
    """Warm one image geometry at several batch sizes (a serving bucket
    stacks requests onto the leading batch dim, so its
    ``backend="auto"`` resolutions look up ``(b, H, W)`` shapes — one per
    padded batch size).

    ``batches`` is an iterable of leading batch sizes (e.g.
    ``repro_torch.serve.bucket_batches(max_batch)``); the remaining
    keyword arguments go to :func:`warm_store`."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    records = []
    for b in batches:
        records.extend(warm_store(shape=(int(b), h, w), **kwargs))
    return records
