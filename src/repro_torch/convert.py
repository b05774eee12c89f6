"""State carried across from the reference package, by duck typing.

Nothing here imports the reference package: :func:`tap_program_from_fields`
reads any object with a tap program's fields, and :func:`pyramid_from_numpy`,
:func:`pyramid3_from_numpy` and :func:`packet_from_numpy` take plain arrays,
so one compiled program, 2-D or 3-D pyramid or packet decomposition made by
the reference can be fed to both packages.  :func:`lm_params_from_numpy`
and :func:`train_state_from_numpy` carry a model's parameters and a whole
training state across (``jax.random`` draws cannot be reproduced in
torch, so two runs that must agree start from the same values).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.compiler.ir import Node, TapProgram, Term
from repro_torch.engine.plan import resolve_device
from repro_torch.engine.pyramid import Pyramid, Pyramid3, WaveletPacket2D


def tap_program_from_fields(obj) -> TapProgram:
    """Rebuild a :class:`TapProgram` from an object exposing
    ``nodes[*].kind / .j / .terms[*].(src, km, kn, c)`` and ``outputs``."""
    nodes = tuple(
        Node(kind=str(nd.kind), j=int(nd.j),
             terms=tuple(Term(src=int(t.src), km=int(t.km), kn=int(t.kn),
                              c=float(t.c)) for t in nd.terms))
        for nd in obj.nodes)
    return TapProgram(nodes=nodes, outputs=tuple(int(o) for o in obj.outputs))


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device)


def pyramid_from_numpy(ll, details: Sequence[Sequence], device="cpu"
                       ) -> Pyramid:
    """Build a :class:`Pyramid` from array-likes (coarsest detail triple
    first, as :class:`Pyramid` stores them) on ``device``."""
    return Pyramid(ll=_tensor(ll, device),
                   details=[tuple(_tensor(d, device) for d in det)
                            for det in details])


def pyramid3_from_numpy(ll, details: Sequence[Sequence], device="cpu"
                        ) -> Pyramid3:
    """Build a :class:`Pyramid3` from array-likes: the tLLL volume and one
    7-subband tuple per level, coarsest first, in the order of
    :data:`~repro_torch.engine.pyramid.Detail3`."""
    return Pyramid3(ll=_tensor(ll, device),
                    details=[tuple(_tensor(d, device) for d in det)
                             for det in details])


def packet_from_numpy(paths: Sequence[str], leaves: Sequence,
                      device="cpu") -> WaveletPacket2D:
    """Build a :class:`WaveletPacket2D` from leaf paths and one array-like
    per leaf, in the same (canonical) order."""
    return WaveletPacket2D(paths=tuple(paths),
                           leaves=[_tensor(a, device) for a in leaves])


def _leaf_tensor(a, device, requires_grad=False) -> torch.Tensor:
    """An array-like as a tensor of its dtype (bfloat16 arrays, which
    numpy lacks, go through float32 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    t = t.to(device)
    return t.requires_grad_(True) if requires_grad else t


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def lm_params_from_numpy(tree, cfg, device="cuda"):
    """An :class:`~repro_torch.models.lm.LM` on ``device`` holding the
    reference's parameters (a nested dict of arrays in the reference's
    layout)."""
    from repro_torch.models.lm import LM
    device = resolve_device(device)
    params = pytree.tree_map(lambda a: _leaf_tensor(a, device), dict(tree))
    return LM(cfg, params=params)


def train_state_from_numpy(state, cfg, device="cuda"):
    """A :class:`~repro_torch.runtime.steps.TrainState` on ``device``
    holding the reference's training state: ``params``,
    ``opt.count/mu/nu``, ``efb`` and ``step``, given as the reference's
    ``TrainState`` of arrays (or dicts with those fields)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.runtime.steps import TrainState
    device = resolve_device(device)
    params = lm_params_from_numpy(_field(state, "params"), cfg,
                                  device).tree()
    opt = _field(state, "opt")
    conv = lambda tree: pytree.tree_map(
        lambda a: _leaf_tensor(a, device), dict(tree))
    efb = _field(state, "efb")
    return TrainState(
        params=params,
        opt=AdamWState(count=_leaf_tensor(_field(opt, "count"), "cpu"),
                       mu=conv(_field(opt, "mu")),
                       nu=conv(_field(opt, "nu"))),
        efb=conv(efb) if efb else {},
        step=_leaf_tensor(_field(state, "step"), "cpu"))
