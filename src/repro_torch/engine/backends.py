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

PyTorch runs eagerly, so every backend chains levels in Python;
``fuse="levels"`` differs from ``"scheme"`` only in name here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.engine import executor as X

__all__ = ["Backend", "BackendError", "register_backend", "get_backend",
           "available_backends", "capability_matrix"]

#: backends of the reference package this port does not have yet
UNPORTED_BACKENDS = ("auto", "xla")


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

    def capabilities(self) -> dict:
        return {"backend": self.name, "fuse_modes": self.fuse_modes,
                "compute_dtypes": self.compute_dtypes,
                "io_dtypes": self.io_dtypes,
                "window_kernel": self.window_kernel,
                "pyramid_kernel": self.pyramid_kernel,
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
        if plan.key.fuse == "none":
            return plan.num_steps
        if plan.key.fuse == "pyramid" and plan.pyramid is not None:
            return 1
        return len(plan.level_specs)


register_backend(TorchBackend())
register_backend(CudaBackend())
