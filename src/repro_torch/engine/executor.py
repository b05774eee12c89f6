"""Plan executors, one class per plan kind, and the level arithmetic
behind the backends' level hooks.

:func:`kind` is the one place a plan's kind is decided: :class:`LevelChain`
(the 2-D pyramid), :class:`Pyramid` (one K2 or K3 launch),
:class:`Packets`, :class:`Volume` (t+2D), :class:`Reversible` or
``Tiled`` (:mod:`repro_torch.tiling.api`).  An executor owns all that
depends on the kind: ``forward`` / ``inverse`` (the raw execution),
``launches()``, ``hbm_bytes(op)``, ``macs(op)`` and ``prepare(device)``
(the kernels to build and tables to upload).  Its models are class
methods of a key and its level specs, which
:func:`repro_torch.profiler.model.config_features` calls without a plan.
A backend adds its hooks and the two flags the models read,
``window_kernel`` and ``launches_programs``.  A new kind is one class
here plus the backend hooks it calls.

The level functions (torch rolls, the CUDA window kernel, ``F.conv2d``)
accept batched ``(..., H, W)`` input: the torch path broadcasts over
leading dims, the window kernel flattens them into its batch grid
dimension, the conv path into the conv's N dimension.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import compiler as C
from repro_torch import telemetry as T
from repro_torch.compiler import conv as CV
from repro_torch.compiler import execute as CX
from repro_torch.compiler import temporal as TP
from repro_torch.core import packets as PK
from repro_torch.core import schemes as S
from repro_torch.core.wavelets import is_reversible
from repro_torch.faults import inject as FI
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import pyramid_window as PW
from repro_torch.kernels import rev_lift as RL
from repro_torch.kernels import tap_window as TW
from repro_torch.kernels import temporal_lift as TL

#: counted gated=False: the dict view ``engine.plan.COUNTERS`` over it
#: counted in every telemetry mode before it was a view, and still does
PYRAMID_LAUNCHES = T.counter(
    "repro_pyramid_kernel_launches_total",
    "fused-pyramid executions (one K2 or K3 launch each on the card)",
    gated=False)


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
# The executors, one per plan kind
# ---------------------------------------------------------------------------

def kind(key, pyramid: bool = False) -> type:
    """The executor class of a plan of ``key``; ``pyramid``: the plan
    resolved the fused-pyramid kernels."""
    if is_reversible(key.wavelet):
        return Reversible
    if key.tiles is not None:
        # deferred: tiling sits above the engine and imports it back
        from repro_torch.tiling import api as TA
        return TA.Tiled
    if key.packet is not None:
        return Packets
    if key.ndim == 3:
        return Volume
    return Pyramid if pyramid else LevelChain


def _itemsize(key) -> int:
    return getattr(torch, key.dtype).itemsize


def unique_bytes(key) -> int:
    """The input read once and every output written once: the traffic
    of a backend with no model of its own (``"torch"`` and ``"conv"``)."""
    return 2 * math.prod(key.shape) * _itemsize(key)


def _programs(spec, op: str):
    return spec.inv_programs if op == "inverse" else spec.fwd_programs


class Executor:
    """What every kind shares: the plan's key, level specs and backend,
    how often each level's 2-D transform runs, and the MACs of its
    compiled programs."""

    def __init__(self, plan, backend):
        self.key, self.specs, self.backend = (plan.key, plan.level_specs,
                                              backend)

    @staticmethod
    def level_runs(key):
        """How many times each level's 2-D transform runs per
        execution."""
        return (1,) * key.levels

    @staticmethod
    def level_images(key):
        """Images in one run of each level's 2-D transform (the batch)."""
        return (math.prod(key.shape[:-2]),) * key.levels

    @classmethod
    def level_samples(cls, key, specs) -> int:
        """Samples of each level's images (one run of it), summed."""
        return sum(images * h * w for (h, w), images in zip(
            (s.image_shape for s in specs), cls.level_images(key)))

    @classmethod
    def model_macs(cls, key, specs, op: str) -> Optional[int]:
        """Compiled MACs of one ``op`` execution (all levels, every run
        of a level, batch included), or None when the plan walks raw
        matrices (no compiled programs to count)."""
        total = 0
        for spec, runs, images in zip(specs, cls.level_runs(key),
                                      cls.level_images(key)):
            programs = _programs(spec, op)
            if programs is None:
                return None
            hp, wp = spec.plane_shape
            # program MACs are per polyphase position (4 output samples)
            total += (C.program_stats(programs)["macs"] * hp * wp * runs
                      * images)
        return total

    def macs(self, op: str = "forward") -> Optional[int]:
        return self.model_macs(self.key, self.specs, op)


class LevelChain(Executor):
    """The 2-D pyramid: each level through the backend's level hooks, in
    one ``level.*`` span a level (timed on the card for a CUDA plan).
    The base of the other kinds that run level by level."""

    FORWARD_SPAN, INVERSE_SPAN = "level.forward", "level.inverse"

    def level_forward(self, x, spec):
        return self.backend.level_forward(x, spec, self.key)

    def level_inverse(self, planes, spec):
        return self.backend.level_inverse(planes, spec, self.key)

    def forward(self, x):
        """x -> (ll, details coarsest-first)."""
        device, name = self.key.device, self.backend.name
        details = []
        ll = x
        for spec in self.specs:
            with T.device_span(self.FORWARD_SPAN, device, level=spec.index,
                               backend=name):
                ll, hl, lh, hh = self.level_forward(ll, spec)
            details.append((hl, lh, hh))
        return ll, tuple(details[::-1])

    def inverse(self, ll, details):
        """(ll, details coarsest-first) -> x."""
        device, name = self.key.device, self.backend.name
        for spec, (hl, lh, hh) in zip(reversed(self.specs), details):
            with T.device_span(self.INVERSE_SPAN, device, level=spec.index,
                               backend=name):
                ll = self.level_inverse((ll, hl, lh, hh), spec)
        return ll

    @classmethod
    def model_launches(cls, backend, key, specs) -> int:
        """One launch per compiled program of every run of a level (each
        barrier step under ``fuse="none"``, the level's whole chain
        otherwise; ``F.conv2d`` calls on ``"conv"``); none on a backend
        that launches no kernels of its own."""
        if not backend.launches_programs:
            return 0
        return sum(runs * len(spec.fwd_programs)
                   for spec, runs in zip(specs, cls.level_runs(key)))

    @classmethod
    def model_bytes(cls, backend, key, specs, op: str) -> int:
        """Device-memory bytes of one ``op`` execution: on the window
        kernel each level's :func:`~repro_torch.kernels.polyphase.
        scheme_hbm_bytes`, once per run of the level and image; else
        :func:`unique_bytes`."""
        if not backend.window_kernel:
            return unique_bytes(key)
        itemsize = _itemsize(key)
        return sum(runs * images * PP.scheme_hbm_bytes(
                       _programs(spec, op), spec.image_shape, itemsize,
                       spec.block)
                   for spec, runs, images in zip(specs, cls.level_runs(key),
                                                 cls.level_images(key)))

    def launches(self) -> int:
        return self.model_launches(self.backend, self.key, self.specs)

    def hbm_bytes(self, op: str = "forward") -> int:
        return self.model_bytes(self.backend, self.key, self.specs, op)

    def prepare(self, device) -> None:
        """Build the window kernel and upload every level's tables."""
        TW.LIBRARY.library()
        for spec in self.specs:
            for win in spec.fwd_windows + spec.inv_windows:
                win.device_table(device)


class Packets(LevelChain):
    """A wavelet-packet tree: each internal node through the backend's
    level hooks, in one ``packet.*`` span a node.  A node at depth d has
    exactly the geometry of pyramid level d, so the plan's level specs
    (and the window kernel's block for that plane shape) are reused by
    depth."""

    def __init__(self, plan, backend):
        super().__init__(plan, backend)
        tree = PK.PacketTree(self.key.packet)
        self.internal, self.leaves = tree.internal_nodes(), tree.leaves

    @staticmethod
    def level_runs(key):
        """Once per internal node at each depth."""
        depths = [len(p) for p in PK.PacketTree(key.packet).internal_nodes()]
        return tuple(depths.count(d) for d in range(key.levels))

    def forward(self, x):
        """image -> leaf tensors in canonical order (a tuple)."""
        key, name = self.key, self.backend.name
        nodes = {"": x}
        for path in self.internal:
            with T.device_span("packet.forward", key.device,
                               depth=len(path), backend=name):
                children = self.level_forward(nodes.pop(path),
                                              self.specs[len(path)])
            for c, arr in zip(PK.CHILDREN, children):
                nodes[path + c] = arr
        return tuple(nodes[p] for p in self.leaves)

    def inverse(self, leaf_arrays):
        """Canonical leaf tuple -> image, walking the internal nodes
        bottom-up (exact reconstruction from any admissible leaf set)."""
        key, name = self.key, self.backend.name
        nodes = dict(zip(self.leaves, leaf_arrays))
        for path in reversed(self.internal):
            children = tuple(nodes.pop(path + c) for c in PK.CHILDREN)
            with T.device_span("packet.inverse", key.device,
                               depth=len(path), backend=name):
                nodes[path] = self.level_inverse(children,
                                                 self.specs[len(path)])
        return nodes[""]


class Volume(LevelChain):
    """The t+2D volume (..., T, H, W): each level lifts along time
    through the backend's temporal hooks (the plain pass, or on "cuda"
    one launch of the temporal lifting kernel), then transforms both
    temporal half-bands, which ride the leading batch dims, with the
    backend's 2-D level; only the tL·LL subband recurses."""

    def __init__(self, plan, backend):
        super().__init__(plan, backend)
        wavelet = self.key.wavelet
        self.fwd_prog = TP.compile_temporal(wavelet)
        self.inv_prog = TP.compile_temporal(wavelet, inverse=True)
        self.cdt = getattr(torch, self.key.compute_dtype)

    @staticmethod
    def level_runs(key):
        """Twice: both temporal half-bands."""
        return (2,) * key.levels

    @staticmethod
    def level_images(key):
        """The frames of one temporal half-band."""
        lead = math.prod(key.shape[:-3])
        return tuple(lead * (key.shape[-3] >> (l + 1))
                     for l in range(key.levels))

    @classmethod
    def model_bytes(cls, backend, key, specs, op: str) -> int:
        """The levels' bytes plus, on the window kernel, each temporal
        pass: the level's volume (both half-bands' frames) read once, the
        two half-bands written once."""
        total = super().model_bytes(backend, key, specs, op)
        if backend.window_kernel:
            total += 4 * cls.level_samples(key, specs) * _itemsize(key)
        return total

    def forward(self, x):
        """volume -> (lll, details coarsest-first)."""
        key, bk = self.key, self.backend
        details = []
        v = x
        for spec in self.specs:
            with T.device_span("level3.forward", key.device,
                               level=spec.index, backend=bk.name):
                with T.device_span("temporal.forward", key.device):
                    lo, hi = bk.temporal_forward(v, self.fwd_prog, self.cdt)
                v, hl0, lh0, hh0 = self.level_forward(lo, spec)
                llh, hlh, lhh, hhh = self.level_forward(hi, spec)
            details.append((hl0, lh0, hh0, llh, hlh, lhh, hhh))
        return v, tuple(details[::-1])

    def inverse(self, ll, details):
        """(lll, details coarsest-first) -> volume."""
        key, bk = self.key, self.backend
        v = ll
        for spec, det in zip(reversed(self.specs), details):
            hl0, lh0, hh0, llh, hlh, lhh, hhh = det
            with T.device_span("level3.inverse", key.device,
                               level=spec.index, backend=bk.name):
                lo = self.level_inverse((v, hl0, lh0, hh0), spec)
                hi = self.level_inverse((llh, hlh, lhh, hhh), spec)
                with T.device_span("temporal.inverse", key.device):
                    v = bk.temporal_inverse(lo, hi, self.inv_prog, self.cdt)
        return v

    def prepare(self, device) -> None:
        """The window kernel's, and the temporal lifting kernel with the
        tables of both directions' programs (the window-kernel backend's
        temporal hooks launch it; :func:`~repro_torch.kernels.
        temporal_lift.encode` is memoized, so its launches find them)."""
        super().prepare(device)
        TL.LIBRARY.library()
        for prog in (self.fwd_prog, self.inv_prog):
            TL.encode(prog, self.cdt).device_table(device)


class Reversible(LevelChain):
    """A reversible wavelet: the integer path, one level at a time
    through the backend's reversible hooks, in one ``revlift.*`` span a
    level (on "cuda" one launch of the reversible lifting kernel)."""

    FORWARD_SPAN, INVERSE_SPAN = "revlift.forward", "revlift.inverse"

    def level_forward(self, x, spec):
        return self.backend.reversible_forward(x, self.key.wavelet)

    def level_inverse(self, planes, spec):
        return self.backend.reversible_inverse(planes, self.key.wavelet)

    @classmethod
    def model_launches(cls, backend, key, specs) -> int:
        """One program a level: the wavelet's lifting pair."""
        return key.levels if backend.launches_programs else 0

    @classmethod
    def model_bytes(cls, backend, key, specs, op: str) -> int:
        """On the reversible lifting kernel each level reads its image
        (or its four subbands) once and writes its four subbands (or its
        image) once; else :func:`unique_bytes`."""
        if not backend.window_kernel:
            return unique_bytes(key)
        return 2 * cls.level_samples(key, specs) * _itemsize(key)

    def prepare(self, device) -> None:
        RL.LIBRARY.library()


class Pyramid(Executor):
    """The fused pyramid: one K2 (forward) or K3 (inverse) launch for the
    whole multi-level transform, in a ``pyramid.launch`` span; the launch
    is the ``pyramid.launch`` fault-injection site."""

    LAUNCHES = 1

    def __init__(self, plan, backend):
        super().__init__(plan, backend)
        self.spec = plan.pyramid

    @staticmethod
    def model_bytes(key, blocks, programs) -> int:
        """:func:`~repro_torch.kernels.polyphase.pyramid_hbm_bytes`
        (modelled) of a kernel running ``programs`` at the per-level
        ``blocks``, per image."""
        h, w = key.shape[-2:]
        per_image = PP.pyramid_hbm_bytes((h, w), _itemsize(key), blocks,
                                         [p.halo for p in programs])
        return per_image.modelled * (math.prod(key.shape) // (h * w))

    def launches(self) -> int:
        return self.LAUNCHES

    def hbm_bytes(self, op: str = "forward") -> int:
        pw = (self.spec.inv_kernel if op == "inverse"
              else self.spec.fwd_kernel)
        return self.model_bytes(self.key, pw.level_blocks, pw.programs)

    def prepare(self, device) -> None:
        PW.LIBRARY.library()
        for pw in (self.spec.fwd_kernel, self.spec.inv_kernel):
            pw.device_table(device)

    def forward(self, x):
        """x -> (ll, details coarsest-first)."""
        key = self.key
        PYRAMID_LAUNCHES.inc()
        FI.maybe_inject("pyramid.launch", op="forward", scheme=key.scheme)
        batch = x.shape[:-2]
        x3 = x.reshape((-1,) + x.shape[-2:]).contiguous()
        with T.device_span("pyramid.launch", key.device, op="forward",
                           levels=key.levels, scheme=key.scheme):
            ll, details = PW.pyramid_forward(self.spec.fwd_kernel, x3)

        def unflat(p):
            return p.reshape(batch + p.shape[-2:])

        return unflat(ll), tuple(tuple(unflat(d) for d in det)
                                 for det in details[::-1])

    def inverse(self, ll, details):
        """(ll, details coarsest-first, as a :class:`Pyramid` holds them)
        -> x."""
        key = self.key
        PYRAMID_LAUNCHES.inc()
        FI.maybe_inject("pyramid.launch", op="inverse", scheme=key.scheme)
        batch = ll.shape[:-2]

        def flat(p):
            return p.reshape((-1,) + p.shape[-2:]).contiguous()

        subbands = tuple(tuple(flat(d) for d in det)
                         for det in details[::-1])
        with T.device_span("pyramid.launch", key.device, op="inverse",
                           levels=key.levels, scheme=key.scheme):
            x = PW.pyramid_inverse(self.spec.inv_kernel, flat(ll), subbands)
        return x.reshape(batch + x.shape[-2:])
