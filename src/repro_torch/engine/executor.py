"""Per-level executor arithmetic: *how one pyramid level runs* on each
registered backend.

* ``executor.py``  (here)  — level arithmetic: image -> 4 subband planes
  (and back) for the torch roll path and the CUDA window kernel;
* ``backends.py``          — dispatch policy: which fuse modes a backend
  supports, how levels chain, how launches are counted.

All level functions accept batched ``(..., H, W)`` input: the torch path
broadcasts over leading dims, the window kernel flattens them into its
batch grid dimension.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.compiler import execute as CX
from repro_torch.core import schemes as S
from repro_torch.kernels import polyphase as PP


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
