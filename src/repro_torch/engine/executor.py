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

# The first launch of a forward level reads the image (the split folded
# into K1's gather) and the last launch of an inverse level writes it (the
# merge folded into K1's sink): no copy around the kernel.

def cuda_level_forward(x, spec, key):
    return PP.apply_steps_cuda(spec.fwd_steps, x, windows=spec.fwd_windows)


def cuda_level_inverse(planes, spec, key):
    return PP.apply_steps_cuda(spec.inv_steps, planes,
                               windows=spec.inv_windows, image_out=True)


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
# (``level_forward`` / ``level_inverse``): a packet node at depth d has
# exactly the geometry of pyramid level d (the plan's LevelSpecs, and so
# the window kernel's block for that plane shape, are reused by depth),
# and the 3-D transform's temporal half-bands ride the free leading batch
# dims of the 2-D kernels.  The 3-D transform's temporal pass goes through
# the backend's temporal hooks (``temporal_forward`` /
# ``temporal_inverse``): the plain roll pass by default, one temporal
# lifting launch per level and direction on "cuda".  PyTorch runs
# eagerly: every fuse mode chains the nodes in Python
# (``Backend.temporal_fuse`` only decides the fallback a 3-D plan
# records).


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
    :mod:`repro_torch.compiler.temporal`, through the backend's
    ``temporal_forward``) then transforms both temporal half-bands with
    the backend's 2-D level; only the tL·LL subband recurses."""
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
                with T.device_span("temporal.forward", key.device):
                    lo, hi = backend.temporal_forward(v, prog, cdt)
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
                with T.device_span("temporal.inverse", key.device):
                    v = backend.temporal_inverse(lo, hi, prog, cdt)
        return v

    return run


# ---------------------------------------------------------------------------
# reversible wavelets: the integer path, one level at a time
# ---------------------------------------------------------------------------

def make_reversible_forward(plan, backend):
    """Forward executor of a reversible plan: int32 images -> (ll,
    details coarsest-first), each level one ``revlift.forward`` span
    around the backend's reversible level (on "cuda" one launch of the
    reversible lifting kernel)."""
    key, specs = plan.key, plan.level_specs

    def run(x):
        details = []
        ll = x
        for spec in specs:
            with T.device_span("revlift.forward", key.device,
                               level=spec.index, backend=backend.name):
                ll, hl, lh, hh = backend.reversible_forward(ll, key.wavelet)
            details.append((hl, lh, hh))
        return ll, tuple(details[::-1])

    return run


def make_reversible_inverse(plan, backend):
    """Inverse executor of a reversible plan: (ll, details
    coarsest-first) -> int32 images, each level one ``revlift.inverse``
    span."""
    key, specs = plan.key, plan.level_specs

    def run(ll, details):
        for spec, (hl, lh, hh) in zip(reversed(specs), details):
            with T.device_span("revlift.inverse", key.device,
                               level=spec.index, backend=backend.name):
                ll = backend.reversible_inverse((ll, hl, lh, hh),
                                                key.wavelet)
        return ll

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
