"""GQA / MQA / sliding-window attention with chunked scoring and a
KV-cache decode path (the port's copy of ``repro.models.attention``).

Training and prefill never hold the full (S, S) score matrix: queries run
in chunks of ``Q_CHUNK``, each under ``torch.utils.checkpoint``, so the
(C, S) score block of a chunk is recomputed in the backward pass and is
never an autograd residual.  The scores are plain tensor ops written as
the reference's einsums, in its dtypes (scores and softmax in float32),
not a fused attention call: a different reduction order would move the
parity with the reference.  Sliding-window configs keep a ring buffer of
``window`` keys in the decode cache.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = Dict[str, Any]

Q_CHUNK = 512


def init_attention(gen, cfg: ModelConfig, n: int, device) -> Params:
    """Attention parameters of ``n`` stacked layers; the TP padding heads
    (``n_heads_padded`` beyond ``n_heads``) are zero in ``wq`` and
    ``wo``, so they are inert at init, as in the reference."""
    d, kv, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    h, hp = cfg.n_heads, cfg.n_heads_padded
    dt = C.pdtype(cfg)
    wq = C.dense_init(gen, (n, d, hp, hd), dt, d, device)
    wk = C.dense_init(gen, (n, d, kv, hd), dt, d, device)
    wv = C.dense_init(gen, (n, d, kv, hd), dt, d, device)
    wo = C.dense_init(gen, (n, hp, hd, d), dt, h * hd, device)
    if hp != h:
        mask = (torch.arange(hp, device=device) < h).to(dt)
        wq = wq * mask[None, None, :, None]
        wo = wo * mask[None, :, None, None]
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, hp, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((n, kv, hd), dtype=dt, device=device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def _scores_softmax_value(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B, C, H, hd); k/v: (B, S, KV, hd); mask: (C, S) bool."""
    groups = cfg.n_heads_padded // cfg.n_kv_heads
    b, c, h, hd = q.shape
    qg = q.reshape(b, c, cfg.n_kv_heads, groups, hd)
    # jnp.sqrt(hd).astype(q.dtype): the root in float32, then cast
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
    scores = torch.einsum("bckgh,bskh->bkgcs", qg, k) / scale
    scores = torch.where(mask[None, None, None], scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgcs,bskh->bckgh", probs, v)
    return out.reshape(b, c, cfg.n_heads_padded, hd)


def _causal_mask(qpos, key_pos, cfg: ModelConfig, causal: bool):
    if not causal:
        return torch.ones((qpos.shape[0], key_pos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    mask = qpos[:, None] >= key_pos[None, :]
    if cfg.sliding_window:
        mask &= key_pos[None, :] > qpos[:, None] - cfg.sliding_window
    return mask


def attend(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
           positions: Optional[torch.Tensor] = None,
           causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill), q-chunked.

    x: (B, S, D) -> (B, S, D).
    """
    b, s, d = x.shape
    dev = x.device
    if positions is None:
        positions = torch.arange(s, device=dev)[None, :]
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.rope_theta:
        q = C.apply_rope(q, positions, cfg)
        k = C.apply_rope(k, positions, cfg)

    chunk = min(Q_CHUNK, s)
    n_chunks = (s + chunk - 1) // chunk
    pad = n_chunks * chunk - s
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    key_pos = torch.arange(s, device=dev)

    def chunk_fn(qc, k, v, c_idx: int):
        qpos = c_idx * chunk + torch.arange(chunk, device=dev)
        mask = _causal_mask(qpos, key_pos, cfg, causal)
        return _scores_softmax_value(qc, k, v, mask, cfg)

    # recompute scores/probs in the backward pass: the (C, S) score block
    # is the big buffer and must never be kept for autograd
    outs = [checkpoint(chunk_fn, q[:, i * chunk:(i + 1) * chunk], k, v, i,
                       use_reentrant=False)
            for i in range(n_chunks)]
    out = torch.cat(outs, dim=1)[:, :s]
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Sliding-window archs only ever keep ``window`` keys (ring buffer)."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Params:
    """One layer's KV cache (the caller stacks the layers)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    dt = dtype or C.cdtype(cfg)
    length = cache_len(cfg, max_len)
    return {
        "k": torch.zeros((batch, length, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, length, kv, hd), dtype=dt, device=device),
    }


def decode_attend(params: Params, cache: Params, x: torch.Tensor, pos: int,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode step.

    x: (B, 1, D); pos: the current position.  Returns (out, new_cache);
    ``cache`` is left as it was.
    """
    b = x.shape[0]
    dev = x.device
    q, k, v = _project_qkv(params, x, cfg)
    positions = torch.full((b, 1), pos, device=dev)
    if cfg.rope_theta:
        q = C.apply_rope(q, positions, cfg)
        k = C.apply_rope(k, positions, cfg)

    length = cache["k"].shape[1]
    if cfg.sliding_window:
        slot = pos % length          # ring buffer
    else:
        slot = min(pos, length - 1)
    ck = cache["k"].clone()
    cv = cache["v"].clone()
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    key_idx = torch.arange(length, device=dev)
    if cfg.sliding_window:
        # ring buffer: valid entries are the last min(pos+1, length) writes
        age = (slot - key_idx) % length
        valid = age < min(pos + 1, length)
    else:
        valid = key_idx <= pos
    mask = valid[None, :]  # (1, length)

    out = _scores_softmax_value(q, ck.to(q.dtype), cv.to(q.dtype), mask, cfg)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, {"k": ck, "v": cv}


def prefill_attend(params: Params, cache: Params, x: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """Prefill: full causal attention + populate the cache.

    For sliding-window configs only the trailing ``window`` keys are kept.
    """
    y = attend(params, x, cfg, causal=True)
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.rope_theta:
        s = x.shape[1]
        k = C.apply_rope(k, torch.arange(s, device=x.device)[None, :], cfg)
    length = cache["k"].shape[1]
    k_keep = k[:, -length:].to(cache["k"].dtype)
    v_keep = v[:, -length:].to(cache["v"].dtype)
    ck = cache["k"].clone()
    cv = cache["v"].clone()
    ck[:, :k_keep.shape[1]] = k_keep
    cv[:, :v_keep.shape[1]] = v_keep
    return y, {"k": ck, "v": cv}
