"""Backend registry: the engine's single executor-dispatch point.

Each :class:`Backend` declares

* **capabilities** — supported fuse modes, compute dtypes and I/O dtypes;
* a **plan-compatibility check** (:meth:`Backend.validate`) that runs at
  plan build, so an unsupported ``(backend, PlanKey)`` combination fails
  with an error naming the offending PlanKey field;
* the **executor factories** (:meth:`Backend.make_forward` /
  :meth:`Backend.make_inverse`) the plan layer installs as
  ``plan._forward`` / ``plan._inverse``;
* a **launch model** (:meth:`Backend.launches`) — kernel launches per
  execution, what ``DwtPlan.launches`` reports.

Registered backends:

* ``"torch"`` — torch reference: periodic rolls over whole planes,
  broadcasts over batch dims; the numerics oracle (the reference
  package's ``"jnp"``).
* ``"cuda"``  — the hand-written CUDA window kernel
  (:mod:`repro_torch.kernels.tap_window`; the reference's ``"pallas"``):
  one launch per barrier step under ``fuse="none"``, one per level under
  ``"scheme"``/``"levels"``, and one per transform under ``"pyramid"``
  (the fused-pyramid kernels, :mod:`repro_torch.kernels.pyramid_window`);
  a 3-D plan's temporal pass is one launch of the temporal lifting kernel
  per level and direction (:mod:`repro_torch.kernels.temporal_lift`).
  On CPU tensors it runs the kernels' plain versions.
* ``"conv"``  — the compiled tap programs as ``F.conv2d`` calls over the
  stacked polyphase planes (:mod:`repro_torch.compiler.conv`; the
  reference's ``"xla"``): one conv per barrier step under
  ``fuse="none"``, one per level otherwise.
* ``"auto"``  — the profile-guided meta-backend: ``build_plan``
  resolves it through :func:`repro_torch.profiler.auto.choose` to one of
  the three above; plans never execute on it.

PyTorch runs eagerly, so every backend chains levels in Python;
``fuse="levels"`` differs from ``"scheme"`` only in name here.  Packet and
3-D plans run on every backend through its level hooks
(:func:`~repro_torch.engine.executor.make_packet_forward`,
:func:`~repro_torch.engine.executor.make_dwt3_forward`), 3-D plans also
through its temporal hooks (``temporal_forward`` / ``temporal_inverse``:
the plain pass on ``"torch"`` and ``"conv"``, the kernel on ``"cuda"``).

Reversible wavelets (``rev53``, :data:`repro_torch.core.wavelets.
REVERSIBLE`) run through the reversible hooks (``reversible_forward`` /
``reversible_inverse``) of the backends that have an integer path
(``Backend.reversible``): ``"torch"`` runs the plain integer path
(:mod:`repro_torch.core.reversible`), ``"cuda"`` one launch of the
reversible lifting kernel per level and direction
(:mod:`repro_torch.kernels.rev_lift`; its plain version on CPU tensors).
Such a key is checked against :data:`REVERSIBLE_KEY`: the lifting scheme
of Annex F, its symmetric extension, int32 samples, no packets, volumes
or tiles, no fused pyramid; ``"conv"`` and ``"auto"`` have no integer
path.  A float wavelet refuses an integer dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch import telemetry as T
from repro_torch.compiler import temporal as TP
from repro_torch.core import reversible as RV
from repro_torch.core.wavelets import REVERSIBLE, is_reversible
from repro_torch.engine import executor as X
from repro_torch.kernels import rev_lift as RL
from repro_torch.kernels import temporal_lift as TL

__all__ = ["Backend", "BackendError", "register_backend", "get_backend",
           "available_backends", "capability_matrix"]

#: backends of the reference package this port does not have yet (none:
#: ``"auto"``, the last, came with the profiler)
UNPORTED_BACKENDS = ()
#: reference backends whose work a port backend of another name does
RENAMED_BACKENDS = {"xla": "conv"}

#: what a reversible wavelet's PlanKey must hold, by field: Annex F
#: defines its subbands for the separable lifting scheme, on the
#: symmetric extension, over integer samples
REVERSIBLE_KEY = {"scheme": ("sep-lifting",), "boundary": ("symmetric",),
                  "dtype": ("int32",), "compute_dtype": ("int32",),
                  "fuse": ("none", "scheme", "levels")}
#: I/O dtypes no float wavelet takes
INTEGER_DTYPES = ("int8", "uint8", "int16", "int32", "int64")


class BackendError(ValueError):
    """An unknown backend, or a ``(backend, PlanKey)`` combination the
    backend cannot execute.  Raised at plan build with the offending
    PlanKey field named."""


class Backend:
    """One execution strategy for compiled DWT plans.

    Subclasses override the class attributes to declare capabilities and
    the ``level_forward`` / ``level_inverse`` hooks to define execution.
    """

    name: str = "?"
    description: str = ""
    #: fuse modes this backend can execute (PlanKey.fuse)
    fuse_modes: Tuple[str, ...] = ("none", "scheme", "levels", "pyramid")
    #: in-kernel arithmetic dtypes (PlanKey.compute_dtype)
    compute_dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    #: I/O dtypes (PlanKey.dtype); None = any floating dtype
    io_dtypes: Optional[Tuple[str, ...]] = None
    #: True when launches run the window kernel: plans then pick its block
    #: through the SMEM guard and encode every program for it
    window_kernel: bool = False
    #: True when fuse="pyramid" is a real single-launch kernel (not the
    #: per-level chain)
    pyramid_kernel: bool = False
    #: whether packet plans (PlanKey.packet) may run through this backend
    supports_packets: bool = True
    #: whether 3-D (t+2D) plans (PlanKey.ndim == 3) may run through it
    supports_3d: bool = True
    #: True when the t+2D level (temporal lifting + both 2-D half-band
    #: transforms) counts as one fused level under fuse="levels"; False
    #: records on the plan that the temporal pass runs unfused between
    #: the backend's kernels (the reference's pallas capability fallback)
    temporal_fuse: bool = True
    #: True when the backend runs reversible wavelets (the integer path)
    reversible: bool = False

    # -- plan-build hooks --------------------------------------------------

    def validate(self, key) -> None:
        """Reject PlanKeys this backend cannot execute (the message names
        the offending PlanKey field and the supported values)."""
        if is_reversible(key.wavelet):
            self.validate_reversible(key)
            return
        if key.dtype in INTEGER_DTYPES:
            raise BackendError(
                f"wavelet {key.wavelet!r} transforms floating samples, got "
                f"PlanKey.dtype={key.dtype!r}; the integer path is the "
                f"reversible wavelets' ({sorted(REVERSIBLE)}), or cast the "
                f"samples to a floating dtype")
        if key.fuse not in self.fuse_modes:
            raise BackendError(
                f"backend {self.name!r} does not support "
                f"PlanKey.fuse={key.fuse!r}; fuse modes supported by "
                f"{self.name!r}: {self.fuse_modes}")
        if key.compute_dtype not in self.compute_dtypes:
            raise BackendError(
                f"backend {self.name!r} does not support "
                f"PlanKey.compute_dtype={key.compute_dtype!r}; compute "
                f"dtypes supported by {self.name!r}: {self.compute_dtypes}")
        if self.io_dtypes is not None and key.dtype not in self.io_dtypes:
            raise BackendError(
                f"backend {self.name!r} does not support "
                f"PlanKey.dtype={key.dtype!r}; I/O dtypes supported by "
                f"{self.name!r}: {self.io_dtypes}")
        if key.packet is not None and not self.supports_packets:
            raise BackendError(
                f"backend {self.name!r} does not support wavelet-packet "
                f"plans (PlanKey.packet={key.packet!r})")
        if key.ndim == 3 and not self.supports_3d:
            raise BackendError(
                f"backend {self.name!r} does not support 3-D plans "
                f"(PlanKey.ndim=3)")
        if (key.packet is not None or key.ndim == 3) \
                and key.fuse == "pyramid":
            # build_plan demotes user-passed fuse="pyramid" before this
            # check runs
            raise BackendError(
                f"fuse='pyramid' is the 2-D pyramid megakernel; packet "
                f"and 3-D plans on {self.name!r} execute at "
                f"fuse='levels' (build_plan demotes automatically)")

    def validate_reversible(self, key) -> None:
        """The checks of a reversible wavelet's key (:data:`REVERSIBLE_KEY`):
        each names the offending PlanKey field."""
        if not self.reversible:
            raise BackendError(
                f"backend {self.name!r} has no integer path for the "
                f"reversible wavelet {key.wavelet!r} (PlanKey.backend); "
                f"backends with one: "
                f"{[n for n, b in sorted(_REGISTRY.items()) if b.reversible]}")
        for field, allowed in REVERSIBLE_KEY.items():
            value = getattr(key, field)
            if value not in allowed:
                raise BackendError(
                    f"the reversible wavelet {key.wavelet!r} does not "
                    f"support PlanKey.{field}={value!r}; supported: "
                    f"{allowed} (ISO/IEC 15444-1 Annex F)")
        for field, value, plain in (("optimize", key.optimize, False),
                                    ("packet", key.packet, None),
                                    ("tiles", key.tiles, None),
                                    ("ndim", key.ndim, 2)):
            if value != plain:
                raise BackendError(
                    f"the reversible wavelet {key.wavelet!r} runs the "
                    f"plain 2-D pyramid only; PlanKey.{field}={value!r} "
                    f"is not supported (use {plain!r})")

    def program_opt(self, key) -> Optional[str]:
        """Tap-program compilation level for this backend, or None when
        the backend executes the raw matrix walk (``tap_opt="off"``)."""
        return None if key.tap_opt == "off" else key.tap_opt

    def program_fuse(self, key) -> str:
        """Granularity of the compiled programs: ``"none"`` = one program
        per barrier step, anything else = one whole-chain program per
        level.  Default: follow the plan's launch granularity."""
        return key.fuse

    # -- execution ---------------------------------------------------------

    def level_forward(self, x, spec, key):
        """One forward level: image (..., H, W) -> 4 subband planes."""
        raise NotImplementedError

    def level_inverse(self, planes, spec, key):
        """One inverse level: 4 subband planes -> image (..., H, W)."""
        raise NotImplementedError

    def temporal_forward(self, x, prog, compute_dtype):
        """One forward temporal level of a 3-D plan: volume (..., T, H, W)
        -> (low, high) half-bands of T/2 frames.  Default: the plain
        periodic-roll pass (:func:`~repro_torch.compiler.temporal.
        temporal_forward`)."""
        return TP.temporal_forward(x, prog, compute_dtype)

    def temporal_inverse(self, lo, hi, prog, compute_dtype):
        """One inverse temporal level: (low, high) -> volume (..., T, H,
        W).  Default: the plain pass (:func:`~repro_torch.compiler.
        temporal.temporal_inverse`)."""
        return TP.temporal_inverse(lo, hi, prog, compute_dtype)

    def reversible_forward(self, x, wavelet: str):
        """One forward level of a reversible wavelet: int32 images
        (..., H, W) -> (LL, HL, LH, HH)."""
        raise NotImplementedError

    def reversible_inverse(self, planes, wavelet: str):
        """One inverse level of a reversible wavelet: (LL, HL, LH, HH) ->
        int32 images (..., H, W)."""
        raise NotImplementedError

    def make_forward(self, plan):
        """Build the forward executor: x -> (ll, details coarsest-first)."""
        key, specs = plan.key, plan.level_specs

        def run(x):
            details = []
            ll = x
            for spec in specs:
                # one span per level, timed on the card for CUDA plans
                with T.device_span("level.forward", key.device,
                                   level=spec.index, backend=self.name):
                    ll, hl, lh, hh = self.level_forward(ll, spec, key)
                details.append((hl, lh, hh))
            return ll, tuple(details[::-1])

        return run

    def make_inverse(self, plan):
        """Build the inverse executor: (ll, details coarsest-first) -> x."""
        key, specs = plan.key, plan.level_specs

        def run(ll, details):
            for spec, (hl, lh, hh) in zip(reversed(specs), details):
                with T.device_span("level.inverse", key.device,
                                   level=spec.index, backend=self.name):
                    ll = self.level_inverse((ll, hl, lh, hh), spec, key)
            return ll

        return run

    # -- observability -----------------------------------------------------

    def launches(self, plan) -> int:
        """Kernel launches per execution under this plan (0 = the backend
        launches no kernels of its own)."""
        return 0

    @staticmethod
    def level_launches(plan) -> int:
        """Launches of a backend with one launch per program: each level
        runs its barrier steps (``fuse="none"``) or one fused program,
        once per node at that depth (``plan.level_runs``)."""
        return sum(runs * (len(spec.fwd_steps) if plan.key.fuse == "none"
                           else 1)
                   for spec, runs in zip(plan.level_specs, plan.level_runs))

    def capabilities(self) -> dict:
        return {"backend": self.name, "fuse_modes": self.fuse_modes,
                "compute_dtypes": self.compute_dtypes,
                "io_dtypes": self.io_dtypes,
                "window_kernel": self.window_kernel,
                "pyramid_kernel": self.pyramid_kernel,
                "packets": self.supports_packets,
                "supports_3d": self.supports_3d,
                "temporal_fuse": self.temporal_fuse,
                "reversible": (dict(REVERSIBLE_KEY,
                                    wavelets=tuple(sorted(REVERSIBLE)))
                               if self.reversible else None),
                "description": self.description}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register a backend under ``backend.name`` (names are unique)."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    """Resolve a backend by name; unknown names raise a
    :class:`BackendError` listing every registered backend."""
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in UNPORTED_BACKENDS:
            raise BackendError(
                f"backend {name!r} (PlanKey.backend) is not ported to "
                f"repro_torch yet; registered backends: "
                f"{available_backends()}") from None
        if name in RENAMED_BACKENDS:
            raise BackendError(
                f"backend {name!r} (PlanKey.backend) is the reference "
                f"package's name; in repro_torch its work is backend "
                f"{RENAMED_BACKENDS[name]!r} (registered backends: "
                f"{available_backends()})") from None
        raise BackendError(
            f"unknown backend {name!r} (PlanKey.backend); registered "
            f"backends: {available_backends()}") from None


def available_backends() -> Tuple[str, ...]:
    """Names of all registered backends, sorted."""
    return tuple(sorted(_REGISTRY))


def capability_matrix() -> Tuple[dict, ...]:
    """One capability row per registered backend."""
    return tuple(_REGISTRY[n].capabilities() for n in available_backends())


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

class TorchBackend(Backend):
    """Torch reference: periodic rolls over whole (batched) planes.

    No kernels of its own are launched; ``fuse="pyramid"`` runs the
    per-level chain (bit-identical to ``fuse="none"``)."""

    name = "torch"
    description = "torch reference (roll-based periodic convolution)"
    reversible = True

    def program_fuse(self, key) -> str:
        # no launch granularity: always run one whole-chain program/level
        return "scheme"

    def level_forward(self, x, spec, key):
        return X.torch_level_forward(x, spec, key)

    def level_inverse(self, planes, spec, key):
        return X.torch_level_inverse(planes, spec, key)

    # reversible wavelets: the plain integer path
    def reversible_forward(self, x, wavelet):
        return RV.level_forward(x, wavelet)

    def reversible_inverse(self, planes, wavelet):
        return RV.level_inverse(planes, wavelet)


class CudaBackend(Backend):
    """The hand-written CUDA kernels: batch rides a grid dimension, halo
    windows are gathered into shared memory with mod indexing;
    ``fuse="pyramid"`` is the single-launch fused-pyramid pair."""

    name = "cuda"
    description = ("hand-written CUDA window and fused-pyramid kernels "
                   "(plain versions on CPU)")
    io_dtypes = ("float32", "float16", "bfloat16")
    window_kernel = True
    pyramid_kernel = True
    # the window kernel launches per level, so a 3-D plan's temporal pass
    # runs unfused between its launches (recorded on plan.fallback)
    temporal_fuse = False
    reversible = True

    def program_opt(self, key) -> str:
        # "off" runs the lowered raw walk, bit-identical to walking the
        # matrices: the kernel only ever executes programs
        return key.tap_opt

    def level_forward(self, x, spec, key):
        return X.cuda_level_forward(x, spec, key)

    def level_inverse(self, planes, spec, key):
        return X.cuda_level_inverse(planes, spec, key)

    # the temporal pass of a 3-D plan: one temporal_lift launch per level
    # and direction (its plain version on CPU tensors)
    def temporal_forward(self, x, prog, compute_dtype):
        return TL.temporal_lift_forward(x, prog, compute_dtype)

    def temporal_inverse(self, lo, hi, prog, compute_dtype):
        return TL.temporal_lift_inverse(lo, hi, prog, compute_dtype)

    # reversible wavelets: one rev_lift launch per level and direction
    # (its plain version on CPU tensors)
    def reversible_forward(self, x, wavelet):
        return RL.rev_lift_forward(x, wavelet)

    def reversible_inverse(self, planes, wavelet):
        return RL.rev_lift_inverse(planes, wavelet)

    def make_forward(self, plan):
        if plan.pyramid is not None:
            return X.make_pyramid_forward(plan)
        return super().make_forward(plan)  # or the SMEM fallback: "levels"

    def make_inverse(self, plan):
        if plan.pyramid is not None:
            return X.make_pyramid_inverse(plan)
        return super().make_inverse(plan)

    def launches(self, plan) -> int:
        """Window and fused-pyramid kernel launches; a 3-D plan's temporal
        pass adds one temporal lifting launch per level and direction,
        counted under its own kernel.  A reversible plan launches the
        reversible lifting kernel once a level."""
        if is_reversible(plan.key.wavelet):
            return plan.key.levels
        if plan.key.fuse == "pyramid" and plan.pyramid is not None:
            return 1
        return self.level_launches(plan)


class ConvBackend(Backend):
    """``F.conv2d`` execution of the compiled tap programs
    (:mod:`repro_torch.compiler.conv`; the reference's ``"xla"``).

    Each compiled program is composed into one 4-in/4-out filter bank and
    applied as a single conv over the stacked polyphase planes — one conv
    per barrier step under ``fuse="none"``, one fused conv per level
    otherwise, batched over images via the conv's N dimension; cuDNN at
    full fp32 on the card.  ``fuse="pyramid"`` is rejected at plan build:
    there is no single-launch pyramid on this path (use ``"levels"``).
    """

    name = "conv"
    description = ("compiled tap programs as grouped F.conv2d calls "
                   "(cuDNN on the card, TF32 off)")
    fuse_modes = ("none", "scheme", "levels")

    def program_opt(self, key) -> str:
        # conv lowering composes a *program*; "off" (the raw matrix walk)
        # lowers the unoptimized "exact" program, which is term-for-term
        # the raw walk — composition erases the difference anyway
        return "exact" if key.tap_opt == "off" else key.tap_opt

    def level_forward(self, x, spec, key):
        return X.conv_level_forward(x, spec, key)

    def level_inverse(self, planes, spec, key):
        return X.conv_level_inverse(planes, spec, key)

    def launches(self, plan) -> int:
        """``F.conv2d`` calls per execution — the barrier count of the
        scheme under ``fuse="none"`` (ns-* schemes halve it)."""
        return self.level_launches(plan)


class AutoBackend(Backend):
    """Profile-guided meta-backend: ``build_plan`` resolves
    ``backend="auto"`` through :func:`repro_torch.profiler.auto.choose`
    (measured store -> fitted cost model -> cold-start rule) and builds
    the plan on the chosen concrete backend — the returned plan's
    ``key.backend`` is the concrete one and ``plan.auto`` records the
    choice.  The ``fuse``/``tap_opt`` arguments of an auto call are hints
    only: the choice overrides them, so ``validate`` accepts every
    generic key and the chosen backend re-validates after substitution."""

    name = "auto"
    description = ("profile-guided: the measured cost model picks "
                   "(backend, fuse, block, tap_opt) per device")

    def validate(self, key) -> None:
        if is_reversible(key.wavelet):
            # the profile store and the cost model measure float plans
            self.validate_reversible(key)

    def make_forward(self, plan):
        raise BackendError(
            "backend 'auto' resolves to a concrete backend at plan "
            "build; plans never execute on it directly")

    make_inverse = make_forward


register_backend(TorchBackend())
register_backend(CudaBackend())
register_backend(ConvBackend())
register_backend(AutoBackend())
