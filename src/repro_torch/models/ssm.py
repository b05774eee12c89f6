"""Mamba2 (SSD) block, zamba2's backbone layer: chunked training and an
O(1)-state decode step (the port's copy of ``repro.models.ssm``).

The selective state-space recurrence per head

    S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t,      y_t = S_t C_t + D x_t,
    a_t = exp(-dt_t * exp(A_log))

runs in chunks of ``CHUNK`` tokens (the SSD algorithm): the quadratic
intra-chunk form of every chunk at once, then the state carried from
chunk to chunk.  The reference scans the chunks one by one; the sums are
the same, grouped per chunk as there.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = Dict[str, Any]

CHUNK = 64


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, state, heads, head_dim)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, cfg.ssm_state, n_heads, cfg.ssm_head_dim


def init_mamba(gen, cfg: ModelConfig, n: int, device) -> Params:
    """The Mamba2 parameters of ``n`` stacked layers."""
    d = cfg.d_model
    din, ds, nh, hd = dims(cfg)
    dt = C.pdtype(cfg)
    conv_dim = din + 2 * ds
    full = lambda v, *shape: torch.full((n,) + shape, v, dtype=dt,
                                        device=device)
    dense = lambda fan, *shape: C.dense_init(gen, (n,) + shape, dt, fan,
                                             device)
    return {
        "in_proj": dense(d, d, 2 * din + 2 * ds + nh),
        "conv_w": dense(cfg.ssm_conv, cfg.ssm_conv, conv_dim),
        "conv_b": full(0.0, conv_dim),
        "A_log": full(0.0, nh),        # A = -exp(A_log) = -1
        "D": full(1.0, nh),
        "dt_bias": dense(1, nh),
        "norm": full(1.0, din),
        "out_proj": dense(din, din, d),
    }


def _split_proj(params, x, cfg):
    din, ds, nh, hd = dims(cfg)
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z = zxbcdt[..., :din]
    xc = zxbcdt[..., din:2 * din]
    bc = zxbcdt[..., 2 * din:2 * din + 2 * ds]
    dt_raw = zxbcdt[..., 2 * din + 2 * ds:]
    return z, xc, bc, dt_raw


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time, tap by tap, then the bias.
    u: (B, S, C), w: (K, C)."""
    k = w.shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = None
    for i in range(k):
        term = pad[:, i:i + u.shape[1]] * w[i]
        out = term if out is None else out + term
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` (``logaddexp(x, 0)``),
    with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    """Training/prefill forward.  x: (B, S, D) -> (B, S, D).

    With ``return_state=True`` also returns the decode cache (the final
    SSM state and the conv history) for the prefill->decode handoff."""
    b, s, d = x.shape
    din, ds, nh, hd = dims(cfg)
    z, xc, bc, dt_raw = _split_proj(params, x, cfg)
    conv_in = torch.cat([xc, bc], dim=-1)
    conv_out = C.silu(_causal_conv(conv_in, params["conv_w"].to(x.dtype),
                                   params["conv_b"].to(x.dtype)))
    xc = conv_out[..., :din]
    bmat = conv_out[..., din:din + ds]
    cmat = conv_out[..., din + ds:]

    dt_v = _softplus(dt_raw.float() + params["dt_bias"].float())
    a_neg = -torch.exp(params["A_log"].float())
    log_a = dt_v * a_neg                                  # (B,S,nh), <= 0
    xh = xc.reshape(b, s, nh, hd)
    u = xh.float() * dt_v[..., None]                      # dt-scaled input

    # ---- chunked SSD ----
    l = min(CHUNK, s)
    if s % l:
        raise ValueError(f"seq {s} not divisible by chunk {l}")
    nc = s // l
    cum = torch.cumsum(log_a.reshape(b, nc, l, nh), dim=2)   # (B,nc,L,nh)
    uc = u.reshape(b, nc, l, nh, hd)
    bm = bmat.float().reshape(b, nc, l, ds)
    cm = cmat.float().reshape(b, nc, l, ds)

    # intra: y_t += sum_{s<=t} exp(cum_t - cum_s) (B_s . C_t) u_s.  The
    # differences above the diagonal are masked before the exp: the
    # reference masks after it, where a large dt overflows to inf and its
    # backward pass multiplies 0 by inf
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,L,L,nh)
    decay = torch.exp(diff.masked_fill(~mask[:, :, None], -torch.inf))
    cb = torch.einsum("bctk,bclk->bctl", cm, bm)
    y = torch.einsum("bctlh,bclhd->bcthd", cb[..., None] * decay, uc)
    # each chunk's own contribution to the state it hands on
    kdecay = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,L,nh)
    cstate = torch.einsum("bclhd,bclk->bchdk", kdecay[..., None] * uc, bm)
    # inter: the state carried into each chunk
    state = torch.zeros((b, nh, hd, ds), dtype=torch.float32,
                        device=x.device)
    carried = []
    for c in range(nc):
        carried.append(state)
        state = torch.exp(cum[:, c, -1])[..., None, None] * state \
            + cstate[:, c]
    carried = torch.stack(carried, dim=1)                  # (B,nc,nh,hd,ds)
    y = y + torch.einsum("bchdk,bclk->bclhd", carried, cm) \
        * torch.exp(cum)[..., None]
    y = y.reshape(b, s, nh, hd)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, din).to(x.dtype)
    y = C.rms_norm(y * C.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    if return_state:
        cache = {"ssm": state,
                 "conv": conv_in[:, -(cfg.ssm_conv - 1):].float()}
        return out, cache
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> Params:
    """One layer's SSM state and conv history (the caller stacks the
    layers)."""
    din, ds, nh, hd = dims(cfg)
    conv_dim = din + 2 * ds
    return {
        "ssm": torch.zeros((batch, nh, hd, ds), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.float32, device=device),
    }


def mamba_decode_step(params: Params, cache: Params, x: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, D) -> (y, new cache); O(1) per token."""
    b = x.shape[0]
    din, ds, nh, hd = dims(cfg)
    z, xc, bc, dt_raw = _split_proj(params, x, cfg)
    conv_in = torch.cat([xc, bc], dim=-1)                   # (B,1,conv)
    hist = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)
    # the last position of the forward's causal conv, tap by tap in the
    # same order (the reference contracts the taps in one einsum, which
    # rounds a bfloat16 decode differently from its own forward)
    conv_out = C.silu(_causal_conv(hist, params["conv_w"].to(x.dtype),
                                   params["conv_b"].to(x.dtype))[:, -1])
    xc1 = conv_out[:, :din]
    bm = conv_out[:, din:din + ds].float()
    cm = conv_out[:, din + ds:].float()

    dt_v = _softplus(dt_raw[:, 0].float() + params["dt_bias"].float())
    a = torch.exp(dt_v * -torch.exp(params["A_log"].float()))
    xh = xc1.reshape(b, nh, hd).float()
    u = xh * dt_v[..., None]

    s_new = a[..., None, None] * cache["ssm"] \
        + u[..., :, None] * bm[:, None, None, :]
    y = torch.einsum("bhdk,bk->bhd", s_new, cm)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(b, 1, din).to(x.dtype)
    y = C.rms_norm(y * C.silu(z), params["norm"], cfg.norm_eps)
    y = y @ params["out_proj"].to(x.dtype)
    return y, {"ssm": s_new, "conv": hist[:, 1:].float()}
