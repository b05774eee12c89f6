"""DWT execution plans: *what* to compute, resolved once per configuration.

A :class:`DwtPlan` resolves, exactly once per

    (wavelet, scheme, levels, shape, dtype, backend, optimize, fuse,
     boundary, compute_dtype, tap_opt, device)

key, the per-level :class:`~repro_torch.kernels.polyphase.StepSpec`
sequences (forward and inverse), the compiled tap programs, the window
kernel's block and encoded program tables, and the executor callables.
Plans are shared through the LRU cache in :mod:`repro_torch.engine.cache`,
so repeated same-configuration calls have zero rebuild cost.

Execution semantics (see :mod:`repro_torch.engine.backends` /
:mod:`repro_torch.engine.executor`):

* every registered backend accepts batched ``(..., H, W)`` input;
* ``fuse="none"``   — paper-faithful: one kernel launch per barrier step;
* ``fuse="scheme"`` / ``"levels"`` — one launch per level (compound
  halo); PyTorch runs eagerly, so the two differ only in name;
* ``fuse="pyramid"`` — on the ``cuda`` backend the whole multi-level
  transform is **one launch** of a fused-pyramid kernel (forward K2,
  inverse K3, :mod:`repro_torch.kernels.pyramid_window`).  Each is one
  cooperative launch that runs the levels in turn over the whole image,
  each at the per-level path's block and halo, with the LL between
  levels in a scratch plane: K2 folds the split into its gather, K3 the
  merge into its stores.  A shared-memory guard falls back to
  ``"levels"`` execution when a level of either kernel does not fit
  (``$REPRO_TORCH_PYRAMID_SMEM_LIMIT`` bytes, default
  :data:`~repro_torch.kernels.tap_window.SMEM_LIMIT`), counted in
  :data:`COUNTERS` and stated in ``plan.fallback``.  On the ``torch``
  backend ``"pyramid"`` runs the per-level chain (bit-identical to
  ``fuse="none"``).

Wavelet-packet plans (``PlanKey.packet``, the canonical leaf tuple of a
:class:`~repro_torch.core.packets.PacketTree`) and 3-D (t+2D) plans
(``PlanKey.ndim=3``) run on every backend through its level hooks; they
demote ``fuse="pyramid"`` to ``"levels"`` (counted in
:data:`WORKLOAD_COUNTERS`), as the reference does.

``backend="auto"`` keys resolve at build to a concrete backend, fuse and
tap_opt (:func:`repro_torch.profiler.auto.choose`); the plan records the
choice in ``plan.auto``.  The window kernel's block starts from the
block table's target for the key's device
(:mod:`repro_torch.engine.autotune`), else
:data:`~repro_torch.kernels.tap_window.BLOCK_TARGET`.

Tiled plans (``PlanKey.tiles``, 2-D pyramids only) carry a
:class:`~repro_torch.tiling.grid.TileGrid` (``plan.grid``) whose exact
halo margins come from the plan's compiled programs; their executors
(:mod:`repro_torch.tiling.api`) gather the tile
windows, run them through a monolithic *window plan* from the same cache
(tiles stacked onto the batch dims) and stitch the cores.  The outer
plan resolves no fused-pyramid kernel: its window plan does, under its
own shared-memory guard.  A tiled plan's launches are its window plan's.

Reversible wavelets (``rev53``: JPEG 2000's lossless 5-3, ISO/IEC
15444-1 Annex F) take keys of their own (dtype and compute dtype
``"int32"``, boundary ``"symmetric"``, scheme ``"sep-lifting"``; see
:data:`~repro_torch.engine.backends.REVERSIBLE_KEY`) and run through the
backend's reversible hooks, one level at a time: on ``"cuda"`` one
launch of the reversible lifting kernel per level and direction at every
fuse mode, on ``"torch"`` the plain integer path.  Float wavelets keep
the periodic boundary (:data:`BOUNDARIES`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional, Tuple

import torch

from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D

from repro_torch import compiler as C
from repro_torch import telemetry as T
from repro_torch.core import optimize as O
from repro_torch.core import schemes as S
from repro_torch.core.wavelets import REVERSIBLE, is_reversible
from repro_torch.engine import backends as B
from repro_torch.engine import executor as X
from repro_torch.faults import degrade as R
from repro_torch.faults import inject as FI
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import pyramid_window as PW
from repro_torch.kernels import rev_lift as RL
from repro_torch.kernels import tap_window as TW

FUSE_MODES = ("none", "scheme", "levels", "pyramid")
#: the boundary of the float wavelets; the reversible wavelets' is
#: ``B.REVERSIBLE_KEY["boundary"]``
BOUNDARIES = ("periodic",)
COMPUTE_DTYPES = tuple(TW.COMPUTE_DTYPES)

#: shared-memory budget of one fused-pyramid launch, in bytes (the
#: reference's $REPRO_PYRAMID_VMEM_LIMIT)
PYRAMID_SMEM_LIMIT_ENV = "REPRO_TORCH_PYRAMID_SMEM_LIMIT"

# engine-wide observability on the central telemetry registry (the
# reference's metric names; surfaced through repro_torch.engine.stats()
# and the Prometheus exposition).  The counters behind the dict views
# below are gated=False: the views counted in every telemetry mode
# before they were views, and still do
PYRAMID_LAUNCHES = T.counter(
    "repro_pyramid_kernel_launches_total",
    "fused-pyramid executions (one K2 or K3 launch each on the card)",
    gated=False)
VMEM_FALLBACKS = T.counter(
    "repro_vmem_fallbacks_total",
    "fuse='pyramid' plans demoted to fuse='levels' by the shared-memory "
    "guard", gated=False)
PLAN_BUILDS = T.counter(
    "repro_plan_builds_total", "DwtPlan builds (plan-cache misses + "
    "direct build_plan calls)", labelnames=("backend", "fuse", "scheme"))
EXECUTIONS = T.counter(
    "repro_plan_executions_total", "plan executions",
    labelnames=("op", "backend", "fuse", "scheme"))
WORKLOAD_DEMOTIONS = T.counter(
    "repro_workload_fuse_demotions_total",
    "fuse='pyramid' plans demoted to fuse='levels' because the megakernel "
    "is 2-D-pyramid-only (packet / 3-D workloads)",
    labelnames=("workload", "backend"), gated=False)

#: fused-pyramid counters as a dict-style view over the registry:
#: executions of a pyramid plan's single-launch executor (on any device;
#: the kernels' own launch counts are ``pyramid_window.FORWARD`` /
#: ``.INVERSE``) and fuse="pyramid" plans demoted to fuse="levels" by the
#: shared-memory guard (the reference's VMEM guard, same metric)
COUNTERS = T.CounterAlias({
    "pyramid_kernel_launches": ("repro_pyramid_kernel_launches_total", {}),
    "smem_fallbacks": ("repro_vmem_fallbacks_total", {}),
})
#: fuse="pyramid" plans demoted to fuse="levels" because the fused-pyramid
#: kernels are 2-D-pyramid-only, by workload (summed over backends)
WORKLOAD_COUNTERS = T.CounterAlias({
    "packet": ("repro_workload_fuse_demotions_total", {"workload": "packet"}),
    "dwt3": ("repro_workload_fuse_demotions_total", {"workload": "dwt3"}),
})


def pyramid_smem_limit() -> int:
    """Configurable shared-memory budget for the fused-pyramid kernels."""
    v = os.environ.get(PYRAMID_SMEM_LIMIT_ENV)
    return int(v) if v else TW.SMEM_LIMIT


def resolve_device(device) -> torch.device:
    """Normalize a device argument; a CUDA request with no CUDA device
    raises instead of carrying on on the CPU."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                f"available (torch.cuda.is_available() is False); pass "
                f"device=\"cpu\" to run on the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; "
                         f"repro_torch runs on 'cuda' or 'cpu'")
    return d


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything that determines a compiled execution plan.

    ``compute_dtype`` is the in-kernel arithmetic dtype (I/O stays in the
    tensor dtype); ``tap_opt`` is the tap-program compilation level
    ("off" = raw matrix walk, "exact" = bit-preserving compilation,
    "full" = fold + CSE + rank-1 factorization); ``device`` is where the
    plan executes (``"cuda"``, the default, or ``"cuda:0"``, ``"cpu"``);
    :func:`build_plan` and the plan cache resolve it with
    :func:`resolve_device` (see :func:`canonical_key`).
    """

    wavelet: str
    scheme: str
    levels: int
    shape: Tuple[int, ...]  # full input shape, batch dims included
    dtype: str
    backend: str
    optimize: bool
    fuse: str
    boundary: str
    compute_dtype: str = "float32"
    tap_opt: str = "full"
    device: str = "cuda"
    # (tile_h, tile_w) core size for tiled execution, or None (monolithic).
    # Part of the key so tiled plans cache exactly like monolithic ones.
    tiles: Optional[Tuple[int, int]] = None
    # canonical packet-tree leaf paths (repro_torch.core.packets.PacketTree),
    # or None for the plain LL-recursion pyramid; when set, ``levels``
    # equals the tree depth and ``shape`` stays (..., H, W)
    packet: Optional[Tuple[str, ...]] = None
    # 2 = image (..., H, W); 3 = volume (..., T, H, W) — the t+2D
    # transform (1-D temporal lifting + 2-D per half-band, per level)
    ndim: int = 2


def canonical_key(key: PlanKey) -> PlanKey:
    """``key`` with its device resolved (``"cuda"`` -> ``"cuda:<current>"``),
    so every spelling of one device plans once; raises where a CUDA
    device is asked for and there is none."""
    device = str(resolve_device(key.device))
    return key if device == key.device else dataclasses.replace(
        key, device=device)


def max_feasible_levels(h: int, w: int) -> int:
    """Largest pyramid depth for an (h, w) image: both dims must stay
    divisible by 2 at every level (min trailing-zero count)."""
    def tz(n: int) -> int:
        return (n & -n).bit_length() - 1 if n > 0 else 0
    return min(tz(h), tz(w))


def validate_image_geometry(h: int, w: int, levels: int) -> None:
    """Check image dims against ``levels`` with an actionable error that
    names the offending dimension and the max feasible levels, instead
    of failing deep inside a kernel launch."""
    div = 1 << levels
    for name, n in (("H", h), ("W", w)):
        if n % div:
            raise ValueError(
                f"levels={levels} infeasible for image {h}x{w}: {name}={n} "
                f"is not divisible by 2^levels={div}; max feasible levels "
                f"for this image is {max_feasible_levels(h, w)}")


@functools.lru_cache(maxsize=512)
def scheme_steps(wavelet: str, scheme: str, optimize: bool,
                 inverse: bool) -> Tuple[PP.StepSpec, ...]:
    """Scheme algebra -> StepSpec sequence, memoized across all plans."""
    if inverse:
        return tuple(PP.steps_of(S.build_inverse_scheme(wavelet, scheme)))
    sch = (O.build_optimized(wavelet, scheme) if optimize
           else S.build_scheme(wavelet, scheme))
    return tuple(PP.steps_of(sch))


@dataclasses.dataclass
class LevelSpec:
    """Static execution parameters of one pyramid level."""

    index: int                        # 0 = finest (first forward level)
    image_shape: Tuple[int, int]      # (H, W) consumed by the forward step
    plane_shape: Tuple[int, int]      # (H/2, W/2) polyphase planes
    fwd_steps: Tuple[PP.StepSpec, ...]
    inv_steps: Tuple[PP.StepSpec, ...]
    # window-kernel block edges (bh, bw); None on backends without it
    block: Optional[Tuple[int, int]] = None
    # compiled tap programs, one per kernel launch group under the plan's
    # fuse mode (None when the torch backend walks raw matrices)
    fwd_programs: Optional[Tuple[C.TapProgram, ...]] = None
    inv_programs: Optional[Tuple[C.TapProgram, ...]] = None
    # the programs encoded for the window kernel (cuda backend only)
    fwd_windows: Optional[Tuple[TW.WindowProgram, ...]] = None
    inv_windows: Optional[Tuple[TW.WindowProgram, ...]] = None


@dataclasses.dataclass
class PyramidSpec:
    """Static execution parameters of one fused-pyramid plan."""

    block: Tuple[int, int]            # image-space block of level 0: twice
                                      # its plane tile, for both kernels
    covered_shape: Tuple[int, int]    # image dims covered by whole blocks
    fwd_sched: C.PyramidSchedule
    inv_sched: C.PyramidSchedule
    # the two kernels with one whole-chain program per level (see
    # pyramid_programs), both at each level's own plane tile
    # (``fwd_kernel.level_blocks`` == ``inv_kernel.level_blocks``)
    fwd_kernel: PW.PyramidWindow
    inv_kernel: PW.PyramidWindow

    @property
    def smem_bytes(self) -> int:
        """Shared memory of the larger of the two launches."""
        return max(self.fwd_kernel.smem_bytes, self.inv_kernel.smem_bytes)


@dataclasses.dataclass
class DwtPlan:
    """A fully-resolved, reusable multi-level DWT executor.

    Build via :func:`build_plan` (or, preferably, through the LRU cache in
    :mod:`repro_torch.engine.cache`), then call :meth:`execute` /
    :meth:`execute_inverse` any number of times with tensors of exactly
    ``key.shape`` on ``key.device`` / the matching pyramid.
    """

    key: PlanKey
    level_specs: Tuple[LevelSpec, ...]
    _forward: Optional[object] = None   # set by the backend
    _inverse: Optional[object] = None
    # PyramidSpec for fuse="pyramid" cuda plans; None after the
    # shared-memory fallback (the plan then executes as fuse="levels")
    pyramid: Optional[PyramidSpec] = None
    fallback: Optional[str] = None      # why the pyramid kernel was skipped
    # TileGrid when key.tiles is set (executors then come from
    # repro_torch.tiling)
    grid: Optional[object] = None
    # AutoChoice when this plan was resolved from backend="auto" (the
    # cache key says "auto"; ``key`` carries the concrete resolution)
    auto: Optional[object] = None

    @property
    def num_steps(self) -> int:
        """Barriers per image over all levels (the paper's step count)."""
        return sum(len(ls.fwd_steps) for ls in self.level_specs)

    @property
    def backend(self) -> "B.Backend":
        """The registered backend object this plan executes on."""
        return B.get_backend(self.key.backend)

    @property
    def level_runs(self) -> Tuple[int, ...]:
        """How many times each level's 2-D transform runs per execution
        (:func:`level_runs`)."""
        return level_runs(self.key)

    @property
    def level_images(self) -> Tuple[int, ...]:
        """Images in one run of each level's 2-D transform
        (:func:`level_images`)."""
        return level_images(self.key)

    @property
    def tile_count(self) -> Optional[int]:
        """Tiles of a tiled plan's grid, None for a monolithic plan."""
        return self.grid.count if self.grid is not None else None

    @property
    def launches(self) -> int:
        """Kernel launches per execution (forward or inverse) under this
        plan's fuse mode, as modelled by the backend; a tiled plan's are
        those of its forward window plan (fetched through the plan
        cache): the whole grid is one batched window execution."""
        if self.grid is not None:
            from repro_torch.tiling import api as TA
            return TA.window_plan(self, "forward").launches
        return self.backend.launches(self)

    def _check_device(self, t: torch.Tensor, what: str) -> None:
        if str(t.device) != self.key.device:
            raise ValueError(f"plan built for device {self.key.device}, "
                             f"got {what} on {t.device}")

    def prepare(self) -> "DwtPlan":
        """Build the CUDA kernels this plan launches and upload its
        device tables, without launching anything (a no-op on the CPU
        and on backends without kernels of their own): a caller that
        times the plan, or serves it from several threads, does this
        before the first execution, so no build or upload lands in a
        measurement or on a worker's stream."""
        dev = torch.device(self.key.device)
        if dev.type != "cuda" or not self.backend.window_kernel:
            return self
        if is_reversible(self.key.wavelet):
            RL.LIBRARY.library()
            return self
        if self.grid is not None:
            from repro_torch.tiling import api as TA
            for op in ("forward", "inverse"):
                TA.window_plan(self, op).prepare()
            return self
        if self.pyramid is not None:
            PW.LIBRARY.library()
            for pw in (self.pyramid.fwd_kernel, self.pyramid.inv_kernel):
                pw.device_table(dev)
            return self
        TW.LIBRARY.library()
        for spec in self.level_specs:
            for win in spec.fwd_windows + spec.inv_windows:
                win.device_table(dev)
        return self

    def compiled_stats(self) -> Optional[dict]:
        """Aggregate tap-program cost of the finest forward level (the hot
        kernel), or None when the plan walks raw matrices."""
        progs = self.level_specs[0].fwd_programs
        return C.program_stats(progs) if progs is not None else None

    def _dispatch(self, op: str, args):
        """One execution through the resilience plane, inside its
        ``execute.*`` span (timed on the card for a CUDA plan), feeding
        the live roofline when the span measured (without waiting for
        the card)."""
        k = self.key
        EXECUTIONS.inc(op=op, backend=k.backend, fuse=k.fuse,
                       scheme=k.scheme)
        with T.device_span(f"execute.{op}", k.device, backend=k.backend,
                           fuse=k.fuse, scheme=k.scheme,
                           levels=k.levels) as sp:
            # resilient dispatch: retry in place, then walk the
            # capability-checked degradation chain (repro_torch.faults)
            out = R.dispatch(self, op, args)
        if sp.record is not None:
            # timed on the card, it is resolved when the roofline is read
            T.record_span(self, sp.record, op=op)
        return out

    def execute(self, x: torch.Tensor):
        """Forward transform of ``x`` (shape must equal ``key.shape``).

        Returns a :class:`Pyramid` (2-D), :class:`Pyramid3`
        (``key.ndim == 3``) or :class:`WaveletPacket2D`
        (``key.packet``)."""
        k = self.key
        if tuple(x.shape) != k.shape:
            raise ValueError(
                f"plan built for shape {k.shape}, got {tuple(x.shape)}")
        self._check_device(x, "input")
        out = self._dispatch("forward", (x,))
        if k.packet is not None:
            return WaveletPacket2D(paths=k.packet, leaves=list(out))
        ll, details = out
        if k.ndim == 3:
            return Pyramid3(ll=ll, details=list(details))
        return Pyramid(ll=ll, details=list(details))

    def execute_inverse(self, pyr) -> torch.Tensor:
        """Inverse transform of a container produced by :meth:`execute`
        (:class:`Pyramid`, :class:`Pyramid3` or, for packet plans, a
        :class:`WaveletPacket2D` over the leaf set ``key.packet``)."""
        k = self.key
        if k.packet is not None:
            if tuple(pyr.paths) != k.packet:
                raise ValueError(
                    f"plan built for packet leaves {k.packet}, "
                    f"got {tuple(pyr.paths)}")
            self._check_device(pyr.leaves[0], "packet")
            return self._dispatch("inverse", (tuple(pyr.leaves),))
        if pyr.levels != k.levels:
            raise ValueError(
                f"plan built for {k.levels} levels, "
                f"pyramid has {pyr.levels}")
        self._check_device(pyr.ll, "pyramid")
        return self._dispatch(
            "inverse", (pyr.ll, tuple(tuple(d) for d in pyr.details)))


def level_runs(key: PlanKey) -> Tuple[int, ...]:
    """How many times each level's 2-D transform runs per execution of a
    plan of ``key``: once per internal packet node at that depth, twice
    (both temporal half-bands) for a 3-D plan, else once."""
    if key.packet is not None:
        from repro_torch.core import packets as PK
        depths = [len(p) for p in PK.PacketTree(key.packet).internal_nodes()]
        return tuple(depths.count(d) for d in range(key.levels))
    return (2 if key.ndim == 3 else 1,) * key.levels


def level_images(key: PlanKey) -> Tuple[int, ...]:
    """Images in one run of each level's 2-D transform: the batch of a
    2-D or packet plan, the frames of one temporal half-band of a 3-D
    plan."""
    if key.ndim == 3:
        lead = math.prod(key.shape[:-3])
        return tuple(lead * (key.shape[-3] >> (l + 1))
                     for l in range(key.levels))
    return (math.prod(key.shape[:-2]),) * key.levels


def pick_block_target(key: PlanKey) -> Tuple[int, int]:
    """Block target of a plan built without an explicit one: the block
    table's entry for ``(scheme, HxW, fuse, backend)`` on the key's
    device (:mod:`repro_torch.engine.autotune`), else
    :data:`~repro_torch.kernels.tap_window.BLOCK_TARGET`."""
    from repro_torch.engine import autotune as AT
    tuned = AT.lookup(key.scheme, key.shape[-2:], key.fuse, key.backend,
                      key.device)
    return tuned if tuned is not None else TW.BLOCK_TARGET


def _resolve_level(index: int, h: int, w: int, key: PlanKey,
                   fwd: Tuple[PP.StepSpec, ...],
                   inv: Tuple[PP.StepSpec, ...],
                   backend: "B.Backend",
                   block_target: Tuple[int, int] = TW.BLOCK_TARGET
                   ) -> LevelSpec:
    hp, wp = h // 2, w // 2
    fwd_programs = inv_programs = fwd_windows = inv_windows = block = None
    # the backend decides the tap-program compilation level (None = raw
    # matrix walk) and the fuse granularity of its launches: one program
    # per step (fuse="none") or one whole-chain program per level
    opt = backend.program_opt(key)
    if opt is not None:
        pfuse = backend.program_fuse(key)
        fwd_programs = C.compile_scheme_programs(
            key.wavelet, key.scheme, key.optimize, False, opt, pfuse)
        inv_programs = C.compile_scheme_programs(
            key.wavelet, key.scheme, False, True, opt, pfuse)
    if backend.window_kernel:
        # SMEM guard: one block for the level, shrunk from the target
        # until every launch of both directions fits in shared memory
        block = TW.fit_block(fwd_programs + inv_programs, hp, wp,
                             block_target)
        fwd_windows = tuple(TW.encode(p, block, key.compute_dtype)
                            for p in fwd_programs)
        inv_windows = tuple(TW.encode(p, block, key.compute_dtype)
                            for p in inv_programs)
    return LevelSpec(index=index, image_shape=(h, w), plane_shape=(hp, wp),
                     fwd_steps=fwd, inv_steps=inv, block=block,
                     fwd_programs=fwd_programs, inv_programs=inv_programs,
                     fwd_windows=fwd_windows, inv_windows=inv_windows)


def pyramid_programs(key: PlanKey):
    """The fused-pyramid schedules and per-level programs of a plan key:
    ``(fwd schedule, inv schedule, fwd programs, inv programs)``.  The
    schedules are the reference's, built from its programs (none under
    ``tap_opt="off"``, where it walks raw matrices and the reaches are
    the summed step halos); the programs are what the kernels run —
    under ``"off"`` the lowered raw walk, bit-identical to walking the
    matrices, whose halo never exceeds those summed step halos."""
    L = key.levels
    fwd_steps = scheme_steps(key.wavelet, key.scheme, key.optimize, False)
    inv_steps = scheme_steps(key.wavelet, key.scheme, False, True)
    fwd_programs = C.compile_pyramid_programs(
        key.wavelet, key.scheme, key.optimize, False, key.tap_opt, L)
    inv_programs = C.compile_pyramid_programs(
        key.wavelet, key.scheme, False, True, key.tap_opt, L)
    fwd_sched = C.forward_schedule(
        C.level_reaches(fwd_steps, fwd_programs, L), L)
    inv_sched = C.inverse_schedule(
        C.level_reaches(inv_steps, inv_programs, L), L)
    fwd_kprogs = fwd_programs or (C.compile_scheme_programs(
        key.wavelet, key.scheme, key.optimize, False, "off", "scheme")
        * L)
    inv_kprogs = inv_programs or (C.compile_scheme_programs(
        key.wavelet, key.scheme, False, True, "off", "scheme") * L)
    return fwd_sched, inv_sched, fwd_kprogs, inv_kprogs


def pyramid_blocks(key: PlanKey, h: int, w: int,
                   block_target: Tuple[int, int] = TW.BLOCK_TARGET):
    """The fused-pyramid kernels' programs and per-level plane tiles of a
    plan key, without encoding a table: ``(fwd schedule, inv schedule,
    fwd programs, inv programs, blocks, why)``, where ``why`` is None or,
    when a level of either kernel does not fit the shared-memory budget
    (:func:`pyramid_smem_limit`), ``(direction, reason)``.

    Both kernels run each level at the window kernel's block for that
    level (:func:`~repro_torch.kernels.tap_window.fit_block` of the
    level's two programs from ``block_target``, as ``fuse="levels"``
    picks it) with its own halo: a kernel's shared memory is its largest
    per-level footprint at level 0's positions per thread."""
    fwd_sched, inv_sched, fwd_kprogs, inv_kprogs = pyramid_programs(key)
    limit = pyramid_smem_limit()
    blocks, why = [], None
    for l, (fp, ip) in enumerate(zip(fwd_kprogs, inv_kprogs)):
        hp, wp = h >> (l + 1), w >> (l + 1)
        try:
            blocks.append(TW.fit_block((fp, ip), hp, wp, block_target,
                                       limit))
        except TW.SmemError as e:
            try:
                TW.fit_block((fp,), hp, wp, block_target, limit)
            except TW.SmemError:
                why = ("forward", f"level {l}'s {e}")
            else:
                why = ("inverse", f"level {l}'s {e}")
            break
    if why is None:
        for direction, progs in (("forward", fwd_kprogs),
                                 ("inverse", inv_kprogs)):
            # fit_block prices each program at its own positions per
            # thread; a kernel walks every level at level 0's (another
            # back pad)
            need = PW.smem_bytes(progs, blocks)
            if need > limit:
                why = (direction, f"needs {need} B of shared memory > "
                                  f"limit {limit} B")
                break
    return fwd_sched, inv_sched, fwd_kprogs, inv_kprogs, blocks, why


def _resolve_pyramid(key: PlanKey, h: int, w: int,
                     block_target: Tuple[int, int] = TW.BLOCK_TARGET
                     ) -> Tuple[Optional[PyramidSpec], Optional[str]]:
    """Resolve the fused-pyramid kernels of a plan at the tiles of
    :func:`pyramid_blocks`.  Where a level of either kernel does not fit,
    the plan falls back to ``fuse="levels"`` execution (counted in
    :data:`COUNTERS`) and says which direction did not fit."""
    fwd_sched, inv_sched, fwd_kprogs, inv_kprogs, blocks, why = \
        pyramid_blocks(key, h, w, block_target)
    if why is not None:
        VMEM_FALLBACKS.inc()
        return None, (f"{why[0]} pyramid: {why[1]}; executing as "
                      f"fuse='levels'")
    fwd = PW.encode_forward(fwd_kprogs, fwd_sched, blocks, key.compute_dtype)
    inv = PW.encode_inverse(inv_kprogs, inv_sched, blocks, key.compute_dtype)
    bh, bw = fwd.block
    return PyramidSpec(
        block=(bh, bw), covered_shape=(-(-h // bh) * bh, -(-w // bw) * bw),
        fwd_sched=fwd_sched, inv_sched=inv_sched, fwd_kernel=fwd,
        inv_kernel=inv), None


def build_plan(key: PlanKey,
               block_target: Optional[Tuple[int, int]] = None) -> DwtPlan:
    """Resolve a :class:`PlanKey` into an executable :class:`DwtPlan`.

    The window kernel's block starts from ``block_target``; ``None``
    takes the block table's entry for the key's device
    (:func:`pick_block_target`), else
    :data:`~repro_torch.kernels.tap_window.BLOCK_TARGET`.  Either way it
    shrinks through the SMEM guard
    (:func:`~repro_torch.kernels.tap_window.fit_block`).

    ``backend="auto"`` delegates to the profiler
    (:func:`repro_torch.profiler.auto.choose`): the measured store, the
    cost model or the cold-start rule picks the concrete ``(backend,
    fuse, block_target, tap_opt)`` for the key's device, and the returned
    plan — bit-identical in output to a direct build of that
    configuration — carries the concrete key plus the
    :class:`~repro_torch.profiler.auto.AutoChoice` on ``plan.auto``.

    Unknown backends and unsupported ``(backend, PlanKey)`` combinations
    raise :class:`~repro_torch.engine.backends.BackendError` here, at
    plan build, with the offending PlanKey field named.  Packet and 3-D
    keys are checked in the reference's order with its texts, and demote
    ``fuse="pyramid"`` to ``"levels"`` (stated in ``plan.fallback``).
    The build runs inside a ``plan.build`` span and is the
    ``plan.build`` fault-injection site.
    """
    key = canonical_key(key)
    with T.span("plan.build", backend=key.backend, fuse=key.fuse,
                scheme=key.scheme, levels=key.levels):
        FI.maybe_inject("plan.build", backend=key.backend, fuse=key.fuse)
        return _build_plan(key, block_target)


def _build_reversible(key: PlanKey, backend: "B.Backend") -> DwtPlan:
    """A reversible wavelet's plan: the backend's checks of its key
    (each naming the field), the geometry, and one level spec per level
    with no steps or programs (the integer path runs the wavelet's
    lifting pair itself)."""
    if key.levels < 1:
        raise ValueError(f"levels must be >= 1, got {key.levels}")
    if len(key.shape) < 2:
        raise ValueError(f"input must be (..., H, W), got {key.shape}")
    backend.validate(key)
    h, w = key.shape[-2], key.shape[-1]
    validate_image_geometry(h, w, key.levels)
    specs = tuple(LevelSpec(index=l, image_shape=(h >> l, w >> l),
                            plane_shape=(h >> (l + 1), w >> (l + 1)),
                            fwd_steps=(), inv_steps=())
                  for l in range(key.levels))
    plan = DwtPlan(key=key, level_specs=specs)
    plan._forward = X.make_reversible_forward(plan, backend)
    plan._inverse = X.make_reversible_inverse(plan, backend)
    return plan


def _build_plan(key: PlanKey,
                block_target: Optional[Tuple[int, int]] = None) -> DwtPlan:
    PLAN_BUILDS.inc(backend=key.backend, fuse=key.fuse, scheme=key.scheme)
    backend = B.get_backend(key.backend)
    if key.fuse not in FUSE_MODES:
        raise ValueError(f"unknown fuse mode {key.fuse!r}; "
                         f"available: {FUSE_MODES}")
    if is_reversible(key.wavelet):
        return _build_reversible(key, backend)
    if key.boundary in B.REVERSIBLE_KEY["boundary"]:
        raise ValueError(
            f"boundary {key.boundary!r} is the reversible wavelets' "
            f"({sorted(REVERSIBLE)}); wavelet {key.wavelet!r} runs on "
            f"{BOUNDARIES}")
    if key.boundary not in BOUNDARIES:
        raise ValueError(f"unknown boundary {key.boundary!r}; "
                         f"available: {BOUNDARIES}")
    if key.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {key.compute_dtype!r}; "
                         f"available: {COMPUTE_DTYPES}")
    if key.tap_opt not in C.OPT_LEVELS:
        raise ValueError(f"unknown tap_opt {key.tap_opt!r}; "
                         f"available: {C.OPT_LEVELS}")
    if key.levels < 1:
        raise ValueError(f"levels must be >= 1, got {key.levels}")
    demoted = None
    if key.ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {key.ndim}")
    if key.packet is not None or key.ndim == 3:
        workload = "packet" if key.packet is not None else "dwt3"
        if key.packet is not None and key.ndim != 2:
            raise ValueError(
                "packet transforms are 2-D (PlanKey.packet with "
                f"ndim={key.ndim}); decompose frames individually or "
                "use the plain 3-D pyramid (ndim=3, packet=None)")
        if key.tiles is not None:
            raise ValueError(
                f"tiled execution (PlanKey.tiles={key.tiles!r}) is "
                f"2-D-pyramid-only; {workload} plans run monolithic")
        if key.packet is not None:
            from repro_torch.core import packets as PK
            tree = PK.PacketTree(key.packet)   # validates admissibility
            if tree.depth != key.levels:
                raise ValueError(
                    f"PlanKey.levels={key.levels} must equal the packet "
                    f"tree depth {tree.depth} (get_plan normalizes this)")
        if key.fuse == "pyramid":
            # the fused-pyramid kernels run the 2-D LL recursion only —
            # packet trees branch into all four children and the 3-D
            # level interleaves a temporal pass
            WORKLOAD_DEMOTIONS.inc(workload=workload, backend=key.backend)
            key = dataclasses.replace(key, fuse="levels")
            demoted = (f"fuse='pyramid' is the 2-D pyramid megakernel; "
                       f"{workload} plan executes as fuse='levels'")
    min_rank = 3 if key.ndim == 3 else 2
    want = "(..., T, H, W)" if key.ndim == 3 else "(..., H, W)"
    if len(key.shape) < min_rank:
        raise ValueError(f"input must be {want}, got {key.shape}")
    backend.validate(key)
    h, w = key.shape[-2], key.shape[-1]
    validate_image_geometry(h, w, key.levels)
    if key.ndim == 3:
        t, div = key.shape[-3], 1 << key.levels
        if t % div:
            raise ValueError(
                f"levels={key.levels} infeasible for volume "
                f"{t}x{h}x{w}: T={t} is not divisible by "
                f"2^levels={div}")

    if key.backend == "auto":
        # profile-guided resolution; the returned plan executes on the
        # chosen backend and records the choice for engine.stats()
        from repro_torch.profiler import auto as PA  # profiler -> engine
        choice = PA.choose(key, block_target=block_target)
        concrete = dataclasses.replace(key, backend=choice.backend,
                                       fuse=choice.fuse,
                                       tap_opt=choice.tap_opt)
        plan = build_plan(concrete,
                          block_target=(block_target if block_target
                                        is not None else choice.block))
        plan.auto = choice
        return plan
    if block_target is None and backend.window_kernel:
        block_target = pick_block_target(key)
    block_target = block_target or TW.BLOCK_TARGET

    fwd = scheme_steps(key.wavelet, key.scheme, key.optimize, False)
    inv = scheme_steps(key.wavelet, key.scheme, False, True)
    specs = tuple(_resolve_level(lvl, h >> lvl, w >> lvl, key, fwd, inv,
                                 backend, block_target)
                  for lvl in range(key.levels))
    plan = DwtPlan(key=key, level_specs=specs, fallback=demoted)
    if key.packet is not None:
        plan._forward = X.make_packet_forward(plan, backend)
        plan._inverse = X.make_packet_inverse(plan, backend)
        return plan
    if key.ndim == 3:
        if key.fuse == "levels" and not backend.temporal_fuse \
                and plan.fallback is None:
            plan.fallback = (
                f"backend {key.backend!r} has no fused t+2D trace; the "
                f"temporal pass runs unfused between its 2-D levels")
        plan._forward = X.make_dwt3_forward(plan, backend)
        plan._inverse = X.make_dwt3_inverse(plan, backend)
        return plan
    if key.fuse == "pyramid" and backend.pyramid_kernel \
            and key.tiles is None:
        plan.pyramid, plan.fallback = _resolve_pyramid(key, h, w,
                                                       block_target)

    if key.tiles is not None:
        # deferred: tiling sits above the engine and imports it back
        from repro_torch.tiling import api as TA
        from repro_torch.tiling import grid as TG
        # under tap_opt="off" the window kernel runs the lowered raw walk,
        # whose reach may be tighter than the summed step halos the
        # reference's kernel path sizes its margins by: keep those (wider,
        # as exact) margins, so both packages tile alike
        plan.grid = TG.build_grid(
            (h, w), key.tiles, key.levels, specs,
            raw_walk=backend.window_kernel and key.tap_opt == "off")
        # the executors build their index tensors and fetch their window
        # plans at first call: a plan fetched only for its grid geometry
        # (stream_dwt2, the dist transport) builds neither
        plan._forward = TA.make_tiled_forward(plan)
        plan._inverse = TA.make_tiled_inverse(plan)
        return plan

    plan._forward = backend.make_forward(plan)
    plan._inverse = backend.make_inverse(plan)
    return plan
