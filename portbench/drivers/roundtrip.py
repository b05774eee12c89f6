"""Round trips through the program's transform entry points, one client
in a closed loop.

A request is a forward transform and the inverse of its pyramid:
``dwt2`` then ``idwt2``, or ``dwt3`` then ``idwt3``, at the
configuration's settings and its ``levels`` for that transform.  The
traffic file's parameters:

``transform``
    ``"dwt2"`` or ``"dwt3"``;
``split``
    the configuration's data array is cut along its first axis into this
    many equal requests, which the loop cycles over;
``inflight``
    requests enqueued at once by the one client: the next request is
    enqueued before the oldest is waited on, so with 2 the card always
    has the next request queued behind the running one;
``check_sample``
    how many requests, drawn from the seed over all requests of the
    window (a reservoir sample), keep their outputs on the card for the
    check.

A request's latency runs from its enqueue on the host to the moment the
host sees it complete on the card.  The check judges every subband of
the forward pyramid and the inverse's reconstruction against the
reference (:func:`compare`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check as CK
from portbench import data as D
from portbench.drivers import Prepared
from portbench.window import Kept, Window, done_marker, split_rows

#: spatial axes of each transform
NDIM = {"dwt2": 2, "dwt3": 3}
INVERSE = {"dwt2": "idwt2", "dwt3": "idwt3"}


@dataclasses.dataclass
class EntryPoints:
    """The two calls of one round trip, and how to flatten what the
    forward returns (coarsest approximation, then each level's details,
    coarsest first)."""

    forward: Callable
    inverse: Callable
    flatten: Callable


def _flat(ll, details) -> List[torch.Tensor]:
    return [ll] + [t for level in details for t in level]


def _levels(config: dict, traffic: dict) -> int:
    return int(config["levels"][traffic["transform"]])


def prepare(program, config: dict, traffic: dict, device) -> Prepared:
    transform, levels = traffic["transform"], _levels(config, traffic)
    data_shape = D.shape_of(config)
    shape = (data_shape[0] // int(traffic["split"]),) + data_shape[1:]
    plan = program.get_plan(
        wavelet=config["wavelet"], scheme=config["scheme"],
        levels=levels, shape=shape, dtype=config["dtype"],
        backend=config["backend"], optimize=False, fuse=config["fuse"],
        boundary=config["boundary"], compute_dtype=config["compute_dtype"],
        tap_opt="full", tiles=None, device=str(device),
        ndim=NDIM[transform])
    plan.prepare()
    kw = dict(wavelet=config["wavelet"], scheme=config["scheme"],
              backend=config["backend"], fuse=config["fuse"],
              boundary=config["boundary"],
              compute_dtype=config["compute_dtype"], device=device)
    fwd = getattr(program, transform)
    inv = getattr(program, INVERSE[transform])
    entry = EntryPoints(forward=lambda x: fwd(x, levels=levels, **kw),
                        inverse=lambda pyr: inv(pyr, **kw),
                        flatten=lambda pyr: _flat(pyr.ll, pyr.details))
    degraded = int(plan.fallback is not None) + int(
        config["fuse"] == "pyramid" and plan.pyramid is None)
    describe = (f"plan {transform} shape={shape} launches={plan.launches} "
                f"pyramid={plan.pyramid is not None} "
                f"fallback={plan.fallback!r}")
    return Prepared(entry, shape, describe, degraded)


def inputs(data: torch.Tensor, traffic: dict) -> List[torch.Tensor]:
    return split_rows(data, int(traffic["split"]))


def request(entry: EntryPoints, x: torch.Tensor):
    return entry.inverse(entry.forward(x))


def warm(entry: EntryPoints, xs: Sequence[torch.Tensor],
         traffic: dict) -> None:
    for i in range(int(traffic["inflight"]) + 1):
        request(entry, xs[i % len(xs)])


def control(reference, config: dict, traffic: dict, device,
            dtype: torch.dtype = torch.bfloat16) -> EntryPoints:
    """The reference computed in ``dtype``, the precision below the
    configuration's float32, with float32 inputs and outputs as the
    program has."""
    transform = traffic["transform"]
    levels = _levels(config, traffic)
    fwd = getattr(reference, transform)
    inv = getattr(reference, INVERSE[transform])
    out = torch.float32

    def forward(x):
        ll, details = fwd(x.to(device), levels, dtype=dtype)
        return ll.to(out), [tuple(t.to(out) for t in d) for d in details]

    def inverse(pyr):
        return inv(*pyr, dtype=dtype).to(out)

    return EntryPoints(forward=forward, inverse=inverse,
                       flatten=lambda pyr: _flat(*pyr))


def run(entry: EntryPoints, xs: List[torch.Tensor], traffic: dict,
        seconds: float, seed: int, device_type: str, tracer=None) -> Window:
    """Issue round trips for ``seconds`` and wait for every one of
    them."""
    inflight = int(traffic["inflight"])
    sample = int(traffic["check_sample"])
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5EED])
    pending: collections.deque = collections.deque()
    reservoir: Dict[int, Kept] = {}
    latencies: List[float] = []
    calls: List[float] = []

    def finish(p):
        with record_function("portbench.wait"):
            p["done"].synchronize()
        latencies.append(time.perf_counter() - p["t0"])

    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        if tracer is not None:
            tracer.tick(t0 - start)
        traced = tracer is not None and tracer.active
        slot = i % len(xs)
        with record_function("portbench.forward"):
            pyr = entry.forward(xs[slot])
        t1 = time.perf_counter()
        with record_function("portbench.inverse"):
            rec = entry.inverse(pyr)
        t2 = time.perf_counter()
        done = done_marker(device_type)
        done.record()
        if not traced:
            calls += [t1 - t0, t2 - t1]
        j = i if i < sample else int(rng.integers(0, i + 1))
        if j < sample:
            reservoir[j] = Kept(i, slot, entry.flatten(pyr) + [rec])
        # the outputs go now (the allocator reuses their memory in
        # stream order), unless the check keeps them
        del pyr, rec
        pending.append({"t0": t0, "done": done})
        i += 1
        while len(pending) >= inflight:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    elapsed = time.perf_counter() - start
    if tracer is not None:
        tracer.stop()
    return Window(seconds=elapsed, latencies_s=latencies, calls_s=calls,
                  kept=sorted(reservoir.values(), key=lambda k: k.index))


def compare(reference, config: dict, traffic: dict, x: torch.Tensor,
            kept: Kept) -> Dict[str, float]:
    """``fwd_err`` and ``inv_err`` of one round trip of ``x`` (see
    :mod:`portbench.check`); ``kept.tensors`` is the program's flat
    pyramid (LL, then each level's details, coarsest first) and its
    reconstruction, last."""
    levels = _levels(config, traffic)
    pyramid, rec = kept.tensors[:-1], kept.tensors[-1]
    if traffic["transform"] == "dwt3":
        return compare_volume(reference, x, levels, pyramid, rec)
    return compare_frames(reference, x, levels, pyramid, rec)


def compare_frames(reference, x, levels, pyramid, rec):
    """``dwt2`` of ``(B, ..., H, W)``, one block of frames at a time."""
    fwd, inv = CK.Worst(len(pyramid)), CK.Worst(1)
    for blk in CK.blocks(x.shape[0], math.prod(x.shape[1:])):
        ll, details = reference.dwt2(x[blk], levels)
        for i, (got, ref) in enumerate(zip(pyramid, _flat(ll, details))):
            fwd.add(i, got[blk], ref)
        inv.add(0, rec[blk], reference.idwt2(ll, details))
        del ll, details
    return {"fwd_err": fwd.scaled(), "inv_err": inv.scaled()}


def compare_volume(reference, x, levels, pyramid, rec):
    """``dwt3`` of the volume ``(T, H, W)``: the reference blocks its
    own passes; the reconstruction is compared in blocks of slices."""
    fwd, inv = CK.Worst(len(pyramid)), CK.Worst(1)
    ll, details = reference.dwt3(x, levels)
    for i, (got, ref) in enumerate(zip(pyramid, _flat(ll, details))):
        fwd.add(i, got, ref)
    back = reference.idwt3(ll, details)
    del ll, details
    for blk in CK.blocks(x.shape[0], math.prod(x.shape[1:])):
        inv.add(0, rec[blk], back[blk])
    return {"fwd_err": fwd.scaled(), "inv_err": inv.scaled()}
