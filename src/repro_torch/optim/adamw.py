"""AdamW with decoupled weight decay, a cosine schedule and clipping by
the global norm (the port's copy of ``repro.optim.adamw``).

Written out rather than ``torch.optim.AdamW``: that orders the decay and
the bias correction differently, and its foreach/fused paths round
differently.  The arithmetic here is the reference's, op for op, in
float32.  Optimizer state mirrors the parameter tree.  ``count`` and the
schedule live on the host as 0-d tensors (a step never waits on the
card to read them).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import RunConfig

F32 = torch.float32


class AdamWState(NamedTuple):
    count: torch.Tensor   # int32, 0-d, on the host
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(count=torch.tensor(0, dtype=torch.int32),
                      mu=pytree.tree_map(zeros, params),
                      nu=pytree.tree_map(zeros, params))


def cosine_lr(step, run: RunConfig) -> torch.Tensor:
    """The learning rate at ``step`` (float32, 0-d)."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - run.warmup_steps)
                       / max(run.total_steps - run.warmup_steps, 1),
                       0.0, 1.0)
    return run.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in pytree.leaves(tree):
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


@torch.no_grad()
def apply(grads, state: AdamWState, params, run: RunConfig,
          clip_norm: float = 1.0) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """Returns (new params, new state, {"lr", "grad_norm"}); the inputs are
    left as they were.  ``grad_norm`` is taken before clipping."""
    count = state.count + 1
    lr = cosine_lr(count, run)

    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2, eps = run.beta1, run.beta2, run.eps
    c = count.to(F32)
    mu_hat_scale = 1.0 / (1 - torch.pow(torch.tensor(b1, dtype=F32), c))
    nu_hat_scale = 1.0 / (1 - torch.pow(torch.tensor(b2, dtype=F32), c))

    def one(g, m, v, p):
        # leaf by leaf: one leaf's clipped gradient and temporaries live
        # at a time, not a clipped copy of the whole tree
        g = g.to(F32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        step_ = m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + eps)
        step_ = step_ + run.weight_decay * p.to(F32)
        return (p.to(F32) - lr * step_).to(p.dtype), m, v

    outs = [one(*xs) for xs in zip(*(pytree.leaves(t) for t in (
        grads, state.mu, state.nu, params)))]
    new_params, mu, nu = (pytree.unflatten(tree, [o[i] for o in outs])
                          for i, tree in enumerate((params, state.mu,
                                                    state.nu)))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_params, AdamWState(count, mu, nu), metrics
