"""Per-level executor arithmetic: *how one pyramid level runs* on each
registered backend.

* ``executor.py``  (here)  — level arithmetic: image -> 4 subband planes
  (and back) for the torch roll path, the CUDA window kernel and the
  ``F.conv2d`` path; the single-launch executors of a fused-pyramid
  plan; and the packet and 3-D executors over any backend's level hooks;
* ``backends.py``          — dispatch policy: which fuse modes a backend
  supports, how levels chain, how launches are counted.

All level functions accept batched ``(..., H, W)`` input: the torch path
broadcasts over leading dims, the window kernel flattens them into its
batch grid dimension, the conv path into the conv's N dimension.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import telemetry as T
from repro_torch.compiler import conv as CV
from repro_torch.compiler import execute as CX
from repro_torch.core import schemes as S
from repro_torch.faults import inject as FI
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import pyramid_window as PW


def apply_steps_torch(steps: Sequence[PP.StepSpec], planes: S.Planes
                      ) -> S.Planes:
    """Run a StepSpec sequence on polyphase planes with the torch
    reference (handles raw and Section-5-optimized step triples alike)."""
    for st in steps:
        for m in st.pre:
            planes = S.apply_matrix(m, planes)
        if st.main is not None:
            planes = S.apply_matrix(st.main, planes)
        for m in st.post:
            planes = S.apply_matrix(m, planes)
    return planes


def run_programs_torch(programs, planes, compute_dtype):
    """Execute compiled tap programs on full planes (periodic rolls),
    computing in ``compute_dtype`` and casting back to the I/O dtype."""
    out_dtype = planes[0].dtype
    cur = [p.to(compute_dtype) for p in planes]
    for prog in programs:
        cur = CX.run_planes(prog, cur)
    return tuple(p.to(out_dtype) for p in cur)


# ---------------------------------------------------------------------------
# torch backend: periodic rolls over whole planes
# ---------------------------------------------------------------------------

def torch_level_forward(x, spec, key):
    """One forward level: image (..., H, W) -> 4 planes (..., H/2, W/2)."""
    planes = S.to_planes(x)
    cdt = getattr(torch, key.compute_dtype)
    if spec.fwd_programs is not None:
        return run_programs_torch(spec.fwd_programs, planes, cdt)
    out_dtype = planes[0].dtype
    planes = tuple(p.to(cdt) for p in planes)
    return tuple(p.to(out_dtype)
                 for p in apply_steps_torch(spec.fwd_steps, planes))


def torch_level_inverse(planes, spec, key):
    """One inverse level: 4 subband planes -> image (..., H, W)."""
    cdt = getattr(torch, key.compute_dtype)
    if spec.inv_programs is not None:
        planes = run_programs_torch(spec.inv_programs, planes, cdt)
    else:
        out_dtype = planes[0].dtype
        planes = tuple(p.to(cdt) for p in planes)
        planes = tuple(p.to(out_dtype)
                       for p in apply_steps_torch(spec.inv_steps, planes))
    return S.from_planes(planes)


# ---------------------------------------------------------------------------
# cuda backend: the hand-written window kernel
# ---------------------------------------------------------------------------

def cuda_level_forward(x, spec, key):
    return PP.apply_steps_cuda(spec.fwd_steps, S.to_planes(x),
                               windows=spec.fwd_windows)


def cuda_level_inverse(planes, spec, key):
    planes = PP.apply_steps_cuda(spec.inv_steps, planes,
                                 windows=spec.inv_windows)
    return S.from_planes(planes)


# ---------------------------------------------------------------------------
# conv backend: one F.conv2d per program over the stacked polyphase planes
# ---------------------------------------------------------------------------

def conv_level_forward(x, spec, key):
    return CV.run_planes_conv(spec.fwd_programs, S.to_planes(x),
                              getattr(torch, key.compute_dtype))


def conv_level_inverse(planes, spec, key):
    planes = CV.run_planes_conv(spec.inv_programs, planes,
                                getattr(torch, key.compute_dtype))
    return S.from_planes(planes)


# ---------------------------------------------------------------------------
# wavelet packets + 3-D (t+2D): generic executors over the level hooks
# ---------------------------------------------------------------------------
#
# Both workloads compose the per-level hooks every backend implements
# (``level_forward`` / ``level_inverse``), so they run on all registered
# backends with no backend-specific kernel work: a packet node at depth d
# has exactly the geometry of pyramid level d (the plan's LevelSpecs, and
# so the window kernel's block for that plane shape, are reused by
# depth), and the 3-D transform's temporal half-bands ride the free
# leading batch dims of the 2-D kernels.  PyTorch runs eagerly: every
# fuse mode chains the nodes in Python (``Backend.temporal_fuse`` only
# decides the fallback a 3-D plan records).


def make_packet_forward(plan, backend):
    """Forward packet executor: image -> leaf tensors in canonical order
    (a tuple)."""
    from repro_torch.core import packets as PK
    key, specs = plan.key, plan.level_specs
    tree = PK.PacketTree(key.packet)
    internal, leaves = tree.internal_nodes(), tree.leaves

    def run(x):
        nodes = {"": x}
        for path in internal:
            with T.device_span("packet.forward", key.device,
                               depth=len(path), backend=backend.name):
                children = backend.level_forward(nodes.pop(path),
                                                 specs[len(path)], key)
            for c, arr in zip(PK.CHILDREN, children):
                nodes[path + c] = arr
        return tuple(nodes[p] for p in leaves)

    return run


def make_packet_inverse(plan, backend):
    """Inverse packet executor: canonical leaf tuple -> image, walking
    the internal nodes bottom-up (exact reconstruction from any
    admissible leaf set)."""
    from repro_torch.core import packets as PK
    key, specs = plan.key, plan.level_specs
    tree = PK.PacketTree(key.packet)
    internal, leaves = tree.internal_nodes(), tree.leaves

    def run(leaf_arrays):
        nodes = dict(zip(leaves, leaf_arrays))
        for path in reversed(internal):
            children = tuple(nodes.pop(path + c) for c in PK.CHILDREN)
            with T.device_span("packet.inverse", key.device,
                               depth=len(path), backend=backend.name):
                nodes[path] = backend.level_inverse(children,
                                                    specs[len(path)], key)
        return nodes[""]

    return run


def make_dwt3_forward(plan, backend):
    """Forward 3-D executor: volume (..., T, H, W) -> (lll, details
    coarsest-first).  Each level lifts along time (periodic 1-D lifting,
    :mod:`repro_torch.compiler.temporal`) then transforms both temporal
    half-bands with the backend's 2-D level; only the tL·LL subband
    recurses."""
    from repro_torch.compiler import temporal as TP
    key, specs = plan.key, plan.level_specs
    prog = TP.compile_temporal(key.wavelet)
    cdt = getattr(torch, key.compute_dtype)

    def run(x):
        details = []
        v = x
        for spec in specs:
            with T.device_span("level3.forward", key.device,
                               level=spec.index, backend=backend.name):
                lo, hi = TP.temporal_forward(v, prog, cdt)
                v, hl0, lh0, hh0 = backend.level_forward(lo, spec, key)
                llh, hlh, lhh, hhh = backend.level_forward(hi, spec, key)
            details.append((hl0, lh0, hh0, llh, hlh, lhh, hhh))
        return v, tuple(details[::-1])

    return run


def make_dwt3_inverse(plan, backend):
    """Inverse 3-D executor: (lll, details coarsest-first) -> volume."""
    from repro_torch.compiler import temporal as TP
    key, specs = plan.key, plan.level_specs
    prog = TP.compile_temporal(key.wavelet, inverse=True)
    cdt = getattr(torch, key.compute_dtype)

    def run(ll, details):
        v = ll
        for spec, det in zip(reversed(specs), details):
            hl0, lh0, hh0, llh, hlh, lhh, hhh = det
            with T.device_span("level3.inverse", key.device,
                               level=spec.index, backend=backend.name):
                lo = backend.level_inverse((v, hl0, lh0, hh0), spec, key)
                hi = backend.level_inverse((llh, hlh, lhh, hhh), spec, key)
                v = TP.temporal_inverse(lo, hi, prog, cdt)
        return v

    return run


# ---------------------------------------------------------------------------
# cuda backend: the fused-pyramid kernels (one launch per transform)
# ---------------------------------------------------------------------------

def make_pyramid_forward(plan):
    """Forward executor of a fused-pyramid plan: one launch for the whole
    multi-level transform (details returned coarsest-first).  The launch
    is the ``pyramid.launch`` fault-injection site and runs inside a
    ``pyramid.launch`` span."""
    from repro_torch.engine import plan as PLAN
    kernel = plan.pyramid.fwd_kernel
    key = plan.key

    def run(x):
        PLAN.PYRAMID_LAUNCHES.inc()
        FI.maybe_inject("pyramid.launch", op="forward", scheme=key.scheme)
        batch = x.shape[:-2]
        x3 = x.reshape((-1,) + x.shape[-2:]).contiguous()
        with T.device_span("pyramid.launch", key.device, op="forward",
                           levels=key.levels, scheme=key.scheme):
            ll, details = PW.pyramid_forward(kernel, x3)

        def unflat(p):
            return p.reshape(batch + p.shape[-2:])

        return unflat(ll), tuple(tuple(unflat(d) for d in det)
                                 for det in details[::-1])

    return run


def make_pyramid_inverse(plan):
    """Inverse executor of a fused-pyramid plan (one launch); takes the
    details coarsest-first, as a :class:`Pyramid` holds them."""
    from repro_torch.engine import plan as PLAN
    kernel = plan.pyramid.inv_kernel
    key = plan.key

    def run(ll, details):
        PLAN.PYRAMID_LAUNCHES.inc()
        FI.maybe_inject("pyramid.launch", op="inverse", scheme=key.scheme)
        batch = ll.shape[:-2]

        def flat(p):
            return p.reshape((-1,) + p.shape[-2:]).contiguous()

        subbands = tuple(tuple(flat(d) for d in det)
                         for det in details[::-1])
        with T.device_span("pyramid.launch", key.device, op="inverse",
                           levels=key.levels, scheme=key.scheme):
            x = PW.pyramid_inverse(kernel, flat(ll), subbands)
        return x.reshape(batch + x.shape[-2:])

    return run
