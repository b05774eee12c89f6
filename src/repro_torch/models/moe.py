"""Mixture-of-Experts FFN with top-k routing (mixtral 8e/top-2, dbrx
16e/top-4): the port's copy of ``repro.models.moe``.

Dispatch is the capacity-based GShard/Switch formulation with fixed
shapes: each expert processes at most
``capacity = int(tokens * top_k / n_experts * capacity_factor)`` tokens;
overflow tokens fall through the residual connection.  Compute is
proportional to the active experts (top_k), not to n_experts.

Two parallelism modes (see :mod:`repro_torch.distributed.sharding`):
  * TP (default): expert weights sharded on d_ff over "model".
  * EP (``EXPERT_PARALLEL``): the expert axis sharded over "model"; the
    ``(E, cap, D)`` dispatch buffer is redistributed to experts over
    "model" (:func:`_shard_experts`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import common as C

Params = Dict[str, Any]

# set by the dry run from RunConfig.expert_parallel (dbrx: 16 experts
# over the 16-way model axis)
EXPERT_PARALLEL = False


def _shard_experts(expert_buf: torch.Tensor) -> torch.Tensor:
    """EP: redistribute an (E, cap, D) DTensor buffer to experts over
    'model' (replicated over the other mesh dims), when ``E`` divides;
    anything else comes back as it is."""
    if not EXPERT_PARALLEL or SH.current_mesh() is None \
            or not SH.is_dtensor(expert_buf):
        return expert_buf
    mesh = expert_buf.device_mesh
    sizes = dict(zip(SH.axis_names(mesh), mesh.shape))
    if "model" not in sizes or expert_buf.shape[0] % sizes["model"] != 0:
        return expert_buf
    return expert_buf.redistribute(
        mesh, SH.placements(SH.P("model", None, None), mesh))


# sequences longer than this (and divisible by it) are dispatched chunk by
# chunk, capacity per chunk, each chunk recomputed in the backward pass;
# read at each call, so a test may patch it
SEQ_CHUNK = 2048


def init_moe(gen, cfg: ModelConfig, n: int, device) -> Params:
    """The router and expert weights of ``n`` stacked layers."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = C.pdtype(cfg)
    return {
        "router": C.dense_init(gen, (n, d, e), dt, d, device),
        "gate": C.dense_init(gen, (n, e, d, f), dt, d, device),
        "up": C.dense_init(gen, (n, e, d, f), dt, d, device),
        "down": C.dense_init(gen, (n, e, f, d), dt, f, device),
    }


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            full_capacity: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    aux_loss is the load-balancing loss (fraction routed first to each
    expert times its mean router probability, summed, times n_experts).
    ``full_capacity=True`` sizes the expert buffers to the worst case
    (capacity = tokens), so no token is dropped: the decode path.
    Sequences longer than ``SEQ_CHUNK`` and divisible by it run chunk by
    chunk (capacity per chunk), each chunk under
    ``torch.utils.checkpoint``.
    """
    dt = x.dtype
    # one cast of each expert weight per call, not one per chunk: at
    # mixtral's width a cast is 470M elements
    w = {"router": params["router"],
         **{k: params[k].to(dt) for k in ("gate", "up", "down")}}
    b, s, d = x.shape
    chunk = SEQ_CHUNK
    if s > chunk and not full_capacity and s % chunk == 0:
        nc = s // chunk
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for i in range(nc):
            xc = x[:, i * chunk:(i + 1) * chunk]
            if torch.is_grad_enabled():
                yc, a = checkpoint(_moe_ffn_flat, w, xc, cfg, False,
                                   use_reentrant=False)
            else:
                yc, a = _moe_ffn_flat(w, xc, cfg, False)
            aux = aux + a / nc
            ys.append(yc)
        return torch.cat(ys, dim=1), aux
    return _moe_ffn_flat(w, x, cfg, full_capacity)


def _moe_ffn_flat(w: Params, x: torch.Tensor, cfg: ModelConfig,
                  full_capacity: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch over all of ``x``'s tokens; ``w`` holds the expert
    weights already in ``x``'s dtype."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = t if full_capacity else _capacity(t, cfg)
    xt = x.reshape(t, d)

    logits = xt.float() @ w["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    # jax.lax.top_k puts the lower index first on ties, torch.topk
    # promises no order; the router runs in float32, so exact ties
    # between two experts' probabilities are rare
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)       # (T, K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # position of each (token, k) within its expert's buffer, counted
    # over (T, K) flattened token-major
    onehot = F.one_hot(expert_idx, e).to(torch.int32)          # (T, K, E)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos = torch.sum(pos_in_expert * onehot, dim=-1)            # (T, K)
    keep = pos < cap

    # (T, K) -> (E, cap) buffers; overflow goes to the extra slot e * cap,
    # which is dropped.  Each kept (t, k) owns its row, so copying rows
    # into zeros is the reference's scatter-add, and deterministic
    disp_idx = expert_idx * cap + torch.where(keep, pos, 0)
    disp_idx = torch.where(keep, disp_idx, e * cap).reshape(-1)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_copy(0, disp_idx, xt.repeat_interleave(k, dim=0))
    expert_in = _shard_experts(buf[:e * cap].reshape(e, cap, d))

    g = torch.bmm(expert_in, w["gate"])
    u = torch.bmm(expert_in, w["up"])
    expert_out = torch.bmm(C.silu(g) * u, w["down"])

    flat_out = torch.cat([expert_out.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)], dim=0)
    gathered = flat_out[disp_idx].reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", gathered,
                     (gate_vals * keep).to(x.dtype)).reshape(b, s, d)

    # load-balancing aux loss
    frac = torch.mean(F.one_hot(expert_idx[:, 0], e).float(), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac * mean_prob)
    return y, aux
