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
* ``fuse="pyramid"`` — the single-launch pyramid kernels are not ported:
  the ``cuda`` backend rejects it at plan build, the ``torch`` backend
  runs the per-level chain.

Fields of the reference's PlanKey that this port does not execute yet
(``tiles``, ``packet``, ``ndim=3``) stay in the key and raise
:class:`~repro_torch.engine.backends.BackendError` at plan build, naming
the field.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.engine.pyramid import Pyramid

from repro_torch import compiler as C
from repro_torch.core import optimize as O
from repro_torch.core import schemes as S
from repro_torch.engine import backends as B
from repro_torch.kernels import polyphase as PP
from repro_torch.kernels import tap_window as TW

FUSE_MODES = ("none", "scheme", "levels", "pyramid")
BOUNDARIES = ("periodic",)
COMPUTE_DTYPES = tuple(TW.COMPUTE_DTYPES)


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
    plan executes (``"cuda:0"``, ``"cpu"``).
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
    device: str = "cpu"
    # reference features not ported yet: must stay at these values
    tiles: Optional[Tuple[int, int]] = None
    packet: Optional[Tuple[str, ...]] = None
    ndim: int = 2


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

    @property
    def num_steps(self) -> int:
        """Barriers per image over all levels (the paper's step count)."""
        return sum(len(ls.fwd_steps) for ls in self.level_specs)

    @property
    def backend(self) -> "B.Backend":
        """The registered backend object this plan executes on."""
        return B.get_backend(self.key.backend)

    @property
    def launches(self) -> int:
        """Kernel launches per execution (forward or inverse) under this
        plan's fuse mode, as modelled by the backend."""
        return self.backend.launches(self)

    def _check_device(self, t: torch.Tensor, what: str) -> None:
        if str(t.device) != self.key.device:
            raise ValueError(f"plan built for device {self.key.device}, "
                             f"got {what} on {t.device}")

    def execute(self, x: torch.Tensor) -> Pyramid:
        """Forward transform of ``x`` (shape must equal ``key.shape``)."""
        if tuple(x.shape) != self.key.shape:
            raise ValueError(
                f"plan built for shape {self.key.shape}, got "
                f"{tuple(x.shape)}")
        self._check_device(x, "input")
        ll, details = self._forward(x)
        return Pyramid(ll=ll, details=list(details))

    def execute_inverse(self, pyr: Pyramid) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` produced by
        :meth:`execute`."""
        if pyr.levels != self.key.levels:
            raise ValueError(
                f"plan built for {self.key.levels} levels, "
                f"pyramid has {pyr.levels}")
        self._check_device(pyr.ll, "pyramid")
        return self._inverse(pyr.ll, tuple(tuple(d) for d in pyr.details))


def _resolve_level(index: int, h: int, w: int, key: PlanKey,
                   fwd: Tuple[PP.StepSpec, ...],
                   inv: Tuple[PP.StepSpec, ...],
                   backend: "B.Backend") -> LevelSpec:
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
        # SMEM guard: one block for the level, shrunk until every launch
        # of both directions fits in shared memory
        block = TW.fit_block(fwd_programs + inv_programs, hp, wp)
        fwd_windows = tuple(TW.encode(p, block, key.compute_dtype)
                            for p in fwd_programs)
        inv_windows = tuple(TW.encode(p, block, key.compute_dtype)
                            for p in inv_programs)
    return LevelSpec(index=index, image_shape=(h, w), plane_shape=(hp, wp),
                     fwd_steps=fwd, inv_steps=inv, block=block,
                     fwd_programs=fwd_programs, inv_programs=inv_programs,
                     fwd_windows=fwd_windows, inv_windows=inv_windows)


def build_plan(key: PlanKey) -> DwtPlan:
    """Resolve a :class:`PlanKey` into an executable :class:`DwtPlan`.

    The window kernel's block starts from
    :data:`~repro_torch.kernels.tap_window.BLOCK_TARGET` and shrinks
    through the SMEM guard (:func:`~repro_torch.kernels.tap_window.fit_block`).

    Unknown backends, unsupported ``(backend, PlanKey)`` combinations and
    reference features not ported yet raise
    :class:`~repro_torch.engine.backends.BackendError` here, at plan
    build, with the offending PlanKey field named.
    """
    backend = B.get_backend(key.backend)
    if key.fuse not in FUSE_MODES:
        raise ValueError(f"unknown fuse mode {key.fuse!r}; "
                         f"available: {FUSE_MODES}")
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
    if key.ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {key.ndim}")
    if key.ndim == 3:
        raise B.BackendError(
            "3-D (t+2D) plans (PlanKey.ndim=3) are not ported to "
            "repro_torch yet")
    if key.packet is not None:
        raise B.BackendError(
            f"wavelet-packet plans (PlanKey.packet={key.packet!r}) are not "
            f"ported to repro_torch yet")
    if key.tiles is not None:
        raise B.BackendError(
            f"tiled execution (PlanKey.tiles={key.tiles!r}) is not ported "
            f"to repro_torch yet")
    if len(key.shape) < 2:
        raise ValueError(f"input must be (..., H, W), got {key.shape}")
    backend.validate(key)
    h, w = key.shape[-2], key.shape[-1]
    validate_image_geometry(h, w, key.levels)

    fwd = scheme_steps(key.wavelet, key.scheme, key.optimize, False)
    inv = scheme_steps(key.wavelet, key.scheme, False, True)
    specs = tuple(_resolve_level(lvl, h >> lvl, w >> lvl, key, fwd, inv,
                                 backend)
                  for lvl in range(key.levels))
    plan = DwtPlan(key=key, level_specs=specs)
    plan._forward = backend.make_forward(plan)
    plan._inverse = backend.make_inverse(plan)
    return plan
