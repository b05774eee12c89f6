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
  (the fused-pyramid kernels, :mod:`repro_torch.kernels.pyramid_window`).
  On CPU tensors it runs the kernels' plain versions.
* ``"conv"``  — the compiled tap programs as ``F.conv2d`` calls over the
  stacked polyphase planes (:mod:`repro_torch.compiler.conv`; the
  reference's ``"xla"``): one conv per barrier step under
  ``fuse="none"``, one per level otherwise.

PyTorch runs eagerly, so every backend chains levels in Python;
``fuse="levels"`` differs from ``"scheme"`` only in name here.  Packet and
3-D plans run on every backend through its level hooks
(:func:`~repro_torch.engine.executor.make_packet_forward`,
:func:`~repro_torch.engine.executor.make_dwt3_forward`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.engine import executor as X

__all__ = ["Backend", "BackendError", "register_backend", "get_backend",
           "available_backends", "capability_matrix"]

#: backends of the reference package this port does not have yet
UNPORTED_BACKENDS = ("auto",)
#: reference backends whose work a port backend of another name does
RENAMED_BACKENDS = {"xla": "conv"}


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

    # -- plan-build hooks --------------------------------------------------

    def validate(self, key) -> None:
        """Reject PlanKeys this backend cannot execute (the message names
        the offending PlanKey field and the supported values)."""
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

    def make_forward(self, plan):
        """Build the forward executor: x -> (ll, details coarsest-first)."""
        key, specs = plan.key, plan.level_specs

        def run(x):
            details = []
            ll = x
            for spec in specs:
                ll, hl, lh, hh = self.level_forward(ll, spec, key)
                details.append((hl, lh, hh))
            return ll, tuple(details[::-1])

        return run

    def make_inverse(self, plan):
        """Build the inverse executor: (ll, details coarsest-first) -> x."""
        key, specs = plan.key, plan.level_specs

        def run(ll, details):
            for spec, (hl, lh, hh) in zip(reversed(specs), details):
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

    def program_fuse(self, key) -> str:
        # no launch granularity: always run one whole-chain program/level
        return "scheme"

    def level_forward(self, x, spec, key):
        return X.torch_level_forward(x, spec, key)

    def level_inverse(self, planes, spec, key):
        return X.torch_level_inverse(planes, spec, key)


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

    def program_opt(self, key) -> str:
        # "off" runs the lowered raw walk, bit-identical to walking the
        # matrices: the kernel only ever executes programs
        return key.tap_opt

    def level_forward(self, x, spec, key):
        return X.cuda_level_forward(x, spec, key)

    def level_inverse(self, planes, spec, key):
        return X.cuda_level_inverse(planes, spec, key)

    def make_forward(self, plan):
        if plan.pyramid is not None:
            return X.make_pyramid_forward(plan)
        return super().make_forward(plan)  # or the SMEM fallback: "levels"

    def make_inverse(self, plan):
        if plan.pyramid is not None:
            return X.make_pyramid_inverse(plan)
        return super().make_inverse(plan)

    def launches(self, plan) -> int:
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


register_backend(TorchBackend())
register_backend(CudaBackend())
register_backend(ConvBackend())
