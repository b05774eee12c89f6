"""RWKV6 ("Finch"): an attention-free RNN with data-dependent decay (the
port's copy of ``repro.models.rwkv``).

Time-mix, per head, with state S in R^{hd x hd}:

    wkv_t = diag(u) k_t v_t^T + S_{t-1}
    y_t   = r_t . wkv_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

where the decay w_t = exp(-exp(ww_t)) comes from a low-rank (LoRA) head
on the token-shifted input.  The state update runs token by token, as
the reference's ``lax.scan`` does, in chunks of ``WKV_CHUNK`` tokens, each
under ``torch.utils.checkpoint`` when gradients are on: the backward pass
keeps one ``(B, nh, hd, hd)`` state per chunk, not one per token, and
recomputes the chunk (the same ops in the same order).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = Dict[str, Any]

DECAY_LORA = 64
HEAD_DIM = 64
WKV_CHUNK = 64


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def init_rwkv_block(gen, cfg: ModelConfig, n: int, device) -> Params:
    """The time-mix and channel-mix parameters of ``n`` stacked layers."""
    d, f = cfg.d_model, cfg.d_ff
    dt = C.pdtype(cfg)
    full = lambda v, *shape: torch.full((n,) + shape, v, dtype=dt,
                                        device=device)
    dense = lambda fan, *shape: C.dense_init(gen, (n,) + shape, dt, fan,
                                             device)
    return {
        # time-mix
        "mix": full(0.5, 5, d),        # r, k, v, g, w lerp coefficients
        "wr": dense(d, d, d),
        "wk": dense(d, d, d),
        "wv": dense(d, d, d),
        "wg": dense(d, d, d),
        "wo": dense(d, d, d),
        "decay_w1": dense(d, d, DECAY_LORA),
        "decay_w2": dense(DECAY_LORA, DECAY_LORA, d),
        "decay_bias": full(-6.0, d),   # slow default decay
        "bonus_u": full(0.0, n_heads(cfg), HEAD_DIM),
        "ln_x": full(1.0, d),
        # channel-mix
        "cmix": full(0.5, 2, d),
        "ck": dense(d, d, f),
        "cv": dense(f, f, d),
        "cr": dense(d, d, d),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried ``prev``, at t=0)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _time_mix_inputs(p: Params, x: torch.Tensor, xx: torch.Tensor,
                     cfg: ModelConfig):
    dt = x.dtype
    mix = p["mix"].to(dt)
    xr, xk, xv, xg, xw = (x * mix[i] + xx * (1 - mix[i]) for i in range(5))
    r = xr @ p["wr"].to(dt)
    k = xk @ p["wk"].to(dt)
    v = xv @ p["wv"].to(dt)
    g = C.silu(xg @ p["wg"].to(dt))
    # data-dependent decay (the v6 LoRA): the bias in float32, the tanh in
    # the compute dtype, then the second matmul in float32
    ww = p["decay_bias"].float() + (
        torch.tanh(xw @ p["decay_w1"].to(dt)).float()
        @ p["decay_w2"].float())
    log_w = -torch.exp(ww)               # log decay, <= 0
    return r, k, v, g, log_w


def _wkv_chunk(state, r, k, v, log_w, u):
    """The recurrence over one chunk of tokens.  Only the state update
    runs token by token; ``wkv_t`` and ``y_t`` (the reference's per-step
    ops) run over the chunk's states at once."""
    kv = k[..., :, None] * v[..., None, :]          # (B, L, nh, hd, hd)
    decay = torch.exp(log_w)[..., None]
    before = []                                     # S_{t-1} per token
    for t in range(r.shape[1]):
        before.append(state)
        state = decay[:, t] * state + kv[:, t]
    wkv = torch.stack(before, dim=1) + u[None, None, :, :, None] * kv
    return torch.einsum("blhi,blhij->blhj", r, wkv), state


def _wkv_scan(r, k, v, log_w, u, state):
    """Recurrent wkv over time.  r/k/v/log_w: (B, S, nh, hd) float32;
    state (B, nh, hd, hd).  Returns (y (B, S, nh, hd), final state)."""
    ys = []
    for i in range(0, r.shape[1], WKV_CHUNK):
        args = [a[:, i:i + WKV_CHUNK] for a in (r, k, v, log_w)]
        if torch.is_grad_enabled():
            y, state = checkpoint(_wkv_chunk, state, *args, u,
                                  use_reentrant=False)
        else:
            y, state = _wkv_chunk(state, *args, u)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, state=None,
             prev=None):
    """x: (B, S, D); ``state`` an optional carried (B, nh, hd, hd) wkv
    state, ``prev`` the carried shift.  Returns (y, state, x[:, -1])."""
    b, s, d = x.shape
    nh = n_heads(cfg)
    xx = _shift(x, prev)
    r, k, v, g, log_w = _time_mix_inputs(p, x, xx, cfg)
    heads = lambda a: a.float().reshape(b, s, nh, HEAD_DIM)
    if state is None:
        state = torch.zeros((b, nh, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                            device=x.device)
    y, state = _wkv_scan(heads(r), heads(k), heads(v), heads(log_w),
                         p["bonus_u"].float(), state)
    y = y.reshape(b, s, d).to(x.dtype)
    y = C.rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return y @ p["wo"].to(x.dtype), state, x[:, -1]


def channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, prev=None):
    """Returns (y, x[:, -1])."""
    dt = x.dtype
    xx = _shift(x, prev)
    mix = p["cmix"].to(dt)
    xk = x * mix[0] + xx * (1 - mix[0])
    xr = x * mix[1] + xx * (1 - mix[1])
    k = torch.square(torch.relu(xk @ p["ck"].to(dt)))
    r = C.sigmoid(xr @ p["cr"].to(dt))
    return r * (k @ p["cv"].to(dt)), x[:, -1]


def init_rwkv_cache(cfg: ModelConfig, batch: int, device) -> Params:
    """One layer's recurrent state (the caller stacks the layers)."""
    nh = n_heads(cfg)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return {"wkv": zeros(batch, nh, HEAD_DIM, HEAD_DIM),
            "tshift": zeros(batch, cfg.d_model),
            "cshift": zeros(batch, cfg.d_model)}
