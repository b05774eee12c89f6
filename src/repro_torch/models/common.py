"""Shared model components: init helpers, norms, RoPE, MLPs, embeddings.

The port's copy of ``repro.models.common``.  Parameters are the
reference's nested dicts of tensors, layers stacked on a leading axis;
every function takes the config explicitly and computes in the dtypes the
reference does (norms and RoPE in float32, matmuls in the compute dtype).
Initial values come from a ``torch.Generator`` and so differ from the
reference's ``jax.random`` draws; :mod:`repro_torch.convert` carries the
reference's values across where two runs must agree.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               fan_in: int, device) -> torch.Tensor:
    """Normal draws truncated to two standard deviations, scaled by
    ``1/sqrt(fan_in)`` (the reference's ``dense_init``; ``shape`` may
    carry the stacked layer axis in front, so ``fan_in`` is explicit)."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (supports partial rotary fraction, phi-4-mini style)
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    rot = int(cfg.head_dim * cfg.rope_fraction) // 2 * 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32,
                            device=device) / rot
    return 1.0 / (cfg.rope_theta ** exponent)  # (rot/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """x: (..., S, n, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(cfg, x.device)
    rot = freqs.shape[0] * 2
    angles = positions[..., :, None].float() * freqs  # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if xp.shape[-1] else yr


def sinusoid_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings ``(length, d)``, float32 (the
    frequencies spread over ``half - 1``, as the reference's)."""
    half = d // 2
    log = torch.log(torch.tensor(10_000.0, dtype=torch.float32,
                                 device=device))
    freq = torch.exp(-log * torch.arange(half, device=device) / (half - 1))
    args = torch.arange(length, device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, n: int, device) -> Params:
    """The MLP of ``n`` stacked layers."""
    f, d = cfg.d_ff, cfg.d_model
    dt = pdtype(cfg)
    if cfg.act == "silu":  # SwiGLU: gate + up + down
        return {
            "gate": dense_init(gen, (n, d, f), dt, d, device),
            "up": dense_init(gen, (n, d, f), dt, d, device),
            "down": dense_init(gen, (n, f, d), dt, f, device),
        }
    return {
        "up": dense_init(gen, (n, d, f), dt, d, device),
        "up_b": torch.zeros((n, f), dtype=dt, device=device),
        "down": dense_init(gen, (n, f, d), dt, f, device),
        "down_b": torch.zeros((n, d), dtype=dt, device=device),
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, each op rounded to ``x``'s dtype: that is
    how the reference's XLA computes ``jax.nn.sigmoid`` in bfloat16
    (equal bit for bit on the CPU), where ``torch.sigmoid`` and
    ``F.silu`` round once and differ in a third of bfloat16 values."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded as :func:`sigmoid` says."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, op for op as ``jax.nn.gelu``."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "silu":
        g = x @ params["gate"].to(dt)
        u = x @ params["up"].to(dt)
        return (silu(g) * u) @ params["down"].to(dt)
    h = gelu_tanh(x @ params["up"].to(dt) + params["up_b"].to(dt))
    return h @ params["down"].to(dt) + params["down_b"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def pad_vocab(v: int, multiple: int = 2048) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def init_embed(gen, cfg: ModelConfig, device) -> Params:
    vp = pad_vocab(cfg.vocab_size)
    dt = pdtype(cfg)
    p = {"tok": dense_init(gen, (vp, cfg.d_model), dt, cfg.d_model, device)}
    if not cfg.tied_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, vp), dt, cfg.d_model,
                               device)
    return p


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    return params["tok"].to(cdtype(cfg))[tokens.long()]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Logits over the padded vocabulary; the padded tail is set to the
    compute dtype's ``finfo.min`` (never sampled, no CE mass)."""
    vp = pad_vocab(cfg.vocab_size)
    w = params["tok"].T if cfg.tied_embeddings else params["head"]
    logits = x @ w.to(x.dtype)
    if vp != cfg.vocab_size:  # mask the padded vocabulary tail
        mask = torch.arange(vp, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    return logits
