"""Language-model assembly for every family of the reference: dense, VLM
(pixtral), MoE (mixtral, dbrx), SSM (RWKV6), hybrid (zamba2) and
encoder-decoder (whisper); the port's copy of ``repro.models.lm``.

Parameters keep the reference's layout: a nested dict with one tensor per
leaf and the layers stacked on a leading ``n_layers`` axis
(``blocks.attn.wq`` is ``(n_layers, d_model, n_heads_padded, head_dim)``;
whisper stacks ``enc_blocks`` and ``dec_blocks``; zamba2's one shared
attention block, ``shared_attn``, is not stacked).  The layout is not
cosmetic: gradient compression works per leaf, and a stacked leaf pads
and wraps into other ``(H, 256)`` tiles than per-layer tensors would; the
same layout makes a checkpoint's leaves the reference's.  The block loop
indexes the stacked leaves (one ``unbind`` per leaf, so the backward pass
stacks the layers' gradients once), and each block runs under
``torch.utils.checkpoint`` when ``remat`` is on, as the reference's
``jax.checkpoint`` of the scanned block.

:class:`LM` is the ``nn.Module`` face: it registers the tree's leaves as
parameters (``named_parameters()`` gives ``blocks.attn.wq``) and calls
the functions below.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as SS

Params = Dict[str, Any]

ATTENTION_FAMILIES = ("dense", "vlm", "moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _attn_mlp_block(gen, cfg: ModelConfig, n: int, device) -> Params:
    ones = lambda: torch.ones((n, cfg.d_model), dtype=C.pdtype(cfg),
                              device=device)
    return {"ln1": ones(), "attn": A.init_attention(gen, cfg, n, device),
            "ln2": ones(), "mlp": C.init_mlp(gen, cfg, n, device)}


def _init_blocks(gen, cfg: ModelConfig, device) -> Params:
    """The stacked backbone blocks of a decoder-only family."""
    n = cfg.n_layers
    ones = lambda: torch.ones((n, cfg.d_model), dtype=C.pdtype(cfg),
                              device=device)
    if cfg.family in ("dense", "vlm"):
        return _attn_mlp_block(gen, cfg, n, device)
    if cfg.family == "moe":
        return {"ln1": ones(), "attn": A.init_attention(gen, cfg, n, device),
                "ln2": ones(), "moe": M.init_moe(gen, cfg, n, device)}
    if cfg.family == "ssm":  # rwkv6
        return {"ln1": ones(), "ln2": ones(),
                "rwkv": R.init_rwkv_block(gen, cfg, n, device)}
    if cfg.family == "hybrid":  # zamba2's mamba backbone layer
        return {"ln1": ones(), "mamba": SS.init_mamba(gen, cfg, n, device)}
    raise ValueError(cfg.family)


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Fresh parameters on ``device``, drawn from ``gen`` (a generator on
    that device)."""
    if cfg.family == "encdec":
        return _init_whisper(gen, cfg, device)
    params: Params = {
        "embed": C.init_embed(gen, cfg, device),
        "blocks": _init_blocks(gen, cfg, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=C.pdtype(cfg),
                                 device=device),
    }
    if cfg.family == "hybrid":
        # zamba2: one *shared* attention+MLP block invoked periodically
        params["shared_attn"] = pytree.tree_map(
            lambda t: t[0].clone(), _attn_mlp_block(gen, cfg, 1, device))
    return params


def _init_whisper(gen, cfg: ModelConfig, device) -> Params:
    d, dt = cfg.d_model, C.pdtype(cfg)
    full = lambda v, *shape: torch.full(shape, v, dtype=dt, device=device)

    def blocks(n, cross):
        p = {"ln1": full(1.0, n, d), "ln1b": full(0.0, n, d),
             "attn": A.init_attention(gen, cfg, n, device),
             "ln2": full(1.0, n, d), "ln2b": full(0.0, n, d),
             "mlp": C.init_mlp(gen, cfg, n, device)}
        if cross:
            p.update(ln_x=full(1.0, n, d), ln_xb=full(0.0, n, d),
                     xattn=A.init_attention(gen, cfg, n, device))
        return p

    return {
        "embed": C.init_embed(gen, cfg, device),
        "enc_blocks": blocks(cfg.enc_layers, False),
        "dec_blocks": blocks(cfg.dec_layers, True),
        "enc_norm": full(1.0, d), "enc_norm_b": full(0.0, d),
        "final_norm": full(1.0, d), "final_norm_b": full(0.0, d),
    }


def layers(blocks: Params) -> List[Params]:
    """The stacked block tree as one tree per layer (views)."""
    flat = [t.unbind(0) for t in pytree.leaves(blocks)]
    return [pytree.unflatten(blocks, [f[i] for f in flat])
            for i in range(len(flat[0]))]


def _stack(trees: List[Params]) -> Params:
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _index(tree: Params, i: int) -> Params:
    return pytree.tree_map(lambda a: a[i], tree)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _run(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(period, groups) of the hybrid's shared-attention schedule."""
    period = cfg.hybrid_period or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.arch_id}: {cfg.n_layers} layers do not "
                         f"split into groups of hybrid_period {period}")
    return period, cfg.n_layers // period


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _attn(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The attention half of a block: (x, the normed input of the FFN)."""
    h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + A.attend(p["attn"], h, cfg)
    return x, C.rms_norm(x, p["ln2"], cfg.norm_eps)


def _attn_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x, h = _attn(p, x, cfg)
    return x + C.mlp(p["mlp"], h, cfg)


def _block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss delta)."""
    if cfg.family in ("dense", "vlm"):
        return _attn_mlp(p, x, cfg), _zero(x)
    if cfg.family == "moe":
        x, h = _attn(p, x, cfg)
        y, aux = M.moe_ffn(p["moe"], h, cfg)
        return x + y, aux
    if cfg.family == "ssm":
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _, _ = R.time_mix(p["rwkv"], h, cfg)
        x = x + y
        h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, _ = R.channel_mix(p["rwkv"], h, cfg)
        return x + y, _zero(x)
    if cfg.family == "hybrid":
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        return x + SS.mamba_forward(p["mamba"], h, cfg), _zero(x)
    raise ValueError(cfg.family)


def _run_blocks(per_layer: List[Params], x, cfg, remat: bool):
    aux = _zero(x)
    for p in per_layer:
        x, d = _run(_block_fwd, remat, p, x, cfg)
        x = C.shard_batch(x)
        aux = aux + d
    return x, aux


def _embed(params, tokens, cfg, embeds):
    x = C.embed(params["embed"], tokens, cfg)
    if embeds is not None:
        sv = embeds.shape[1]
        x = torch.cat([embeds.to(x.dtype), x[:, sv:]], dim=1)
    return x


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   *, embeds: Optional[torch.Tensor] = None,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward up to (and including) the final norm.

    tokens: (B, S) int -> (hidden (B, S, D), aux_loss).  ``embeds``
    (B, S_v, D), if given, replaces the token embeddings of the first S_v
    positions (the VLM stub frontend).
    """
    if cfg.family == "encdec":
        raise ValueError("use whisper_forward for encdec")
    x = C.shard_batch(_embed(params, tokens, cfg, embeds))
    per_layer = layers(params["blocks"])
    if cfg.family == "hybrid" and cfg.hybrid_period:
        # the shared attention block before each group of the mamba stack
        period, n_groups = _groups(cfg)
        aux = _zero(x)
        for g in range(n_groups):
            x = _attn_mlp(params["shared_attn"], x, cfg)
            x, d = _run_blocks(per_layer[g * period:(g + 1) * period], x,
                               cfg, remat)
            aux = aux + d
    else:
        x, aux = _run_blocks(per_layer, x, cfg, remat)
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal LM forward: (B, S) -> (logits (B, S, Vp), aux_loss)."""
    x, aux = forward_hidden(params, tokens, cfg, embeds=embeds, remat=remat)
    return C.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Whisper encoder-decoder
# ---------------------------------------------------------------------------

def _whisper_enc_block(p, x, cfg):
    h = C.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
    x = x + A.attend(p["attn"], h, cfg, causal=False)
    h = C.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
    return x + C.mlp(p["mlp"], h, cfg)


def whisper_encode(params: Params, enc_embeds: torch.Tensor,
                   cfg: ModelConfig, remat: bool = True) -> torch.Tensor:
    """enc_embeds: (B, S_enc, D) stub frame embeddings (the conv/mel
    frontend is a stub; its downsampling happens offline)."""
    b, s, d = enc_embeds.shape
    dt = C.cdtype(cfg)
    x = enc_embeds.to(dt) + C.sinusoid_positions(
        s, d, enc_embeds.device).to(dt)
    for p in layers(params["enc_blocks"]):
        x = _run(_whisper_enc_block, remat, p, x, cfg)
    return C.layer_norm(x, params["enc_norm"], params["enc_norm_b"],
                        cfg.norm_eps)


def _cross_attend(p: Params, x: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    q = SH.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = SH.einsum("bsd,dhk->bshk", enc.to(dt), p["wk"].to(dt))
    v = SH.einsum("bsd,dhk->bshk", enc.to(dt), p["wv"].to(dt))
    mask = torch.ones((x.shape[1], enc.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = A._scores_softmax_value(q, k, v, mask, cfg)
    return SH.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _whisper_dec_block(p, x, enc, cfg):
    h = C.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
    x = x + A.attend(p["attn"], h, cfg, causal=True)
    h = C.layer_norm(x, p["ln_x"], p["ln_xb"], cfg.norm_eps)
    x = x + _cross_attend(p["xattn"], h, enc, cfg)
    h = C.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
    return x + C.mlp(p["mlp"], h, cfg)


def whisper_hidden(params: Params, enc_embeds: torch.Tensor,
                   dec_tokens: torch.Tensor, cfg: ModelConfig,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder hidden states after the final norm, and a zero aux loss."""
    enc = whisper_encode(params, enc_embeds, cfg, remat)
    x = C.embed(params["embed"], dec_tokens, cfg)
    x = x + C.sinusoid_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)
    for p in layers(params["dec_blocks"]):
        x = _run(_whisper_dec_block, remat, p, x, enc, cfg)
    x = C.layer_norm(x, params["final_norm"], params["final_norm_b"],
                     cfg.norm_eps)
    return x, _zero(x)


def whisper_forward(params: Params, enc_embeds: torch.Tensor,
                    dec_tokens: torch.Tensor, cfg: ModelConfig,
                    remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(enc_embeds (B, S_enc, D), dec_tokens (B, T)) -> (logits (B, T,
    Vp), aux_loss)."""
    x, aux = whisper_hidden(params, enc_embeds, dec_tokens, cfg, remat)
    return C.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, *, embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Params]:
    """Returns (last-position logits (B, Vp), decode cache at pos=S)."""
    b, s = tokens.shape
    dev = tokens.device
    x = C.shard_batch(_embed(params, tokens, cfg, embeds))
    remat = remat and torch.is_grad_enabled()
    per_layer = layers(params["blocks"])

    def attn_prefill(p, x):
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, kv = A.prefill_attend(
            p["attn"], A.init_cache(cfg, b, max_len, device=dev), h, cfg)
        return x + y, kv

    if cfg.family in ATTENTION_FAMILIES:
        def body(p, x):
            x, kv = attn_prefill(p, x)
            h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                y, _ = M.moe_ffn(p["moe"], h, cfg)
            else:
                y = C.mlp(p["mlp"], h, cfg)
            return C.shard_batch(x + y), C.shard_batch_tree(kv)

        kvs = []
        for p in per_layer:
            x, kv = _run(body, remat, p, x)
            kvs.append(kv)
        cache = {"kv": _stack(kvs)}

    elif cfg.family == "ssm":
        def body(p, x):
            h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
            y, wkv, tshift = R.time_mix(p["rwkv"], h, cfg)
            x = x + y
            h2 = C.rms_norm(x, p["ln2"], cfg.norm_eps)
            y, cshift = R.channel_mix(p["rwkv"], h2, cfg)
            return x + y, {"wkv": wkv, "tshift": tshift.float(),
                           "cshift": cshift.float()}

        states = []
        for p in per_layer:
            x, st = _run(body, remat, p, x)
            states.append(st)
        cache = {"rwkv": _stack(states)}

    elif cfg.family == "hybrid":
        def body(p, x):
            h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
            y, st = SS.mamba_forward(p["mamba"], h, cfg, return_state=True)
            return x + y, st

        period, n_groups = _groups(cfg)
        sp = params["shared_attn"]
        states, attn_kvs = [], []
        for g in range(n_groups):
            x, kv = attn_prefill(sp, x)
            attn_kvs.append(kv)
            h = C.rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + C.mlp(sp["mlp"], h, cfg)
            for p in per_layer[g * period:(g + 1) * period]:
                x, st = _run(body, remat, p, x)
                states.append(st)
        cache = {"mamba": _stack(states), "attn_kv": _stack(attn_kvs)}
    else:
        raise ValueError(cfg.family)

    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Stacked per-layer decode caches at position 0, on ``device``
    (``"meta"`` for shapes alone)."""
    from repro_torch.engine.plan import resolve_device
    dev = (torch.device(device) if torch.device(device).type == "meta"
           else resolve_device(device))

    def stacked(one, n=cfg.n_layers):
        return pytree.tree_map(
            lambda a: a.expand((n,) + a.shape).clone(), one)

    if cfg.family in ATTENTION_FAMILIES:
        cache = {"kv": stacked(A.init_cache(cfg, batch, max_len,
                                            device=dev))}
    elif cfg.family == "ssm":
        cache = {"rwkv": stacked(R.init_rwkv_cache(cfg, batch, dev))}
    elif cfg.family == "hybrid":
        # the shared attention block runs once per group; each invocation
        # has its own activations and therefore its own KV cache
        _, n_groups = _groups(cfg)
        cache = {"mamba": stacked(SS.init_mamba_cache(cfg, batch, dev)),
                 "attn_kv": stacked(A.init_cache(cfg, batch, max_len,
                                                 device=dev), n_groups)}
    elif cfg.family == "encdec":
        # the self-attention cache over decoder positions and the cross
        # K/V (whisper_prefill computes them from the encoder)
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cross = {k: torch.zeros(shape, dtype=C.cdtype(cfg), device=dev)
                 for k in ("k", "v")}
        cache = {"kv": stacked(A.init_cache(cfg, batch, cfg.max_target_len,
                                            device=dev), cfg.dec_layers),
                 "cross": stacked(cross, cfg.dec_layers)}
    else:
        raise ValueError(cfg.family)
    cache["pos"] = torch.tensor(0, dtype=torch.int32)
    return cache


def _attn_decode(p: Params, cache: Params, x: torch.Tensor, pos: int,
                 cfg: ModelConfig):
    """The attention half of an attention block; returns (x, new kv)."""
    h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, kv = A.decode_attend(p["attn"], cache, h, pos, cfg)
    return x + y, kv


def _block_decode(p: Params, cache: Params, x: torch.Tensor, pos: int,
                  cfg: ModelConfig):
    """One layer's decode step; returns (x, the layer's new cache)."""
    if cfg.family in ATTENTION_FAMILIES:
        x, kv = _attn_decode(p, cache, x, pos, cfg)
        h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            y, _ = M.moe_ffn(p["moe"], h, cfg, full_capacity=True)
            return x + y, kv
        return x + C.mlp(p["mlp"], h, cfg), kv
    if cfg.family == "ssm":
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        r = p["rwkv"]
        xx = cache["tshift"].to(x.dtype)[:, None]
        rr, k, v, g, log_w = R._time_mix_inputs(r, h, xx, cfg)
        b = x.shape[0]
        heads = lambda a: a.float().reshape(b, 1, R.n_heads(cfg), R.HEAD_DIM)
        y, wkv = R._wkv_scan(heads(rr), heads(k), heads(v), heads(log_w),
                             r["bonus_u"].float(), cache["wkv"])
        y = y.reshape(b, 1, cfg.d_model).to(x.dtype)
        y = C.rms_norm(y, r["ln_x"], cfg.norm_eps) * g
        x = x + y @ r["wo"].to(x.dtype)
        h2 = C.rms_norm(x, p["ln2"], cfg.norm_eps)
        y, _ = R.channel_mix(r, h2, cfg, prev=cache["cshift"].to(x.dtype))
        # the new shifts are the block's normed inputs
        return x + y, {"wkv": wkv, "tshift": h[:, -1].float(),
                       "cshift": h2[:, -1].float()}
    if cfg.family == "hybrid":
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, new = SS.mamba_decode_step(p["mamba"], cache, h, cfg)
        return x + y, new
    raise ValueError(cfg.family)


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step of a decoder-only family.  tokens: (B, 1) int.
    Returns (logits (B, Vp), new cache); ``cache`` is left as it was."""
    pos = int(cache["pos"])
    x = C.embed(params["embed"], tokens, cfg)
    per_layer = layers(params["blocks"])
    if cfg.family == "hybrid":
        period, n_groups = _groups(cfg)
        sp = params["shared_attn"]
        states, attn_kvs = [], []
        for g in range(n_groups):
            x, kv = _attn_decode(sp, _index(cache["attn_kv"], g), x, pos,
                                 cfg)
            attn_kvs.append(kv)
            h = C.rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + C.mlp(sp["mlp"], h, cfg)
            for i in range(g * period, (g + 1) * period):
                x, st = _block_decode(per_layer[i],
                                      _index(cache["mamba"], i), x, pos, cfg)
                states.append(st)
        new_cache = {"mamba": _stack(states), "attn_kv": _stack(attn_kvs)}
    else:
        name = "rwkv" if cfg.family == "ssm" else "kv"
        new = []
        for i, p in enumerate(per_layer):
            x, c = _block_decode(p, _index(cache[name], i), x, pos, cfg)
            if name == "kv":
                x = C.shard_batch(x)
            new.append(c)
        new_cache = {name: _stack(new)}
    new_cache["pos"] = torch.tensor(pos + 1, dtype=torch.int32)
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return C.unembed(params["embed"], x, cfg)[:, 0], new_cache


def whisper_prefill(params: Params, enc_embeds: torch.Tensor,
                    cfg: ModelConfig, batch: int) -> Params:
    """Encode, and compute each decoder layer's cross-attention K/V once
    (in the compute dtype): the decode cache at position 0."""
    enc = whisper_encode(params, enc_embeds, cfg)
    cache = init_decode_cache(cfg, batch, cfg.max_target_len,
                              device=enc.device)
    dt = C.cdtype(cfg)
    cache["cross"] = _stack([
        {k: SH.einsum("bsd,dhk->bshk", enc.to(dt),
                         p["xattn"][w].to(dt))
         for k, w in (("k", "wk"), ("v", "wv"))}
        for p in layers(params["dec_blocks"])])
    return cache


def whisper_decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                        cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decoder step against the precomputed cross K/V (the position
    embedding clamps at ``max_target_len - 1``)."""
    pos = int(cache["pos"])
    x = C.embed(params["embed"], tokens, cfg)
    posemb = C.sinusoid_positions(cfg.max_target_len, cfg.d_model, x.device)
    at = min(pos, cfg.max_target_len - 1)
    x = x + posemb[at:at + 1].to(x.dtype)[None]
    kvs = []
    for i, p in enumerate(layers(params["dec_blocks"])):
        h = C.layer_norm(x, p["ln1"], p["ln1b"], cfg.norm_eps)
        y, kv = A.decode_attend(p["attn"], _index(cache["kv"], i), h, pos,
                                cfg)
        kvs.append(kv)
        x = x + y
        h = C.layer_norm(x, p["ln_x"], p["ln_xb"], cfg.norm_eps)
        q = SH.einsum("bsd,dhk->bshk", h, p["xattn"]["wq"].to(x.dtype))
        ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
        mask = torch.ones((1, ck.shape[1]), dtype=torch.bool, device=x.device)
        out = A._scores_softmax_value(q, ck.to(x.dtype), cv.to(x.dtype),
                                      mask, cfg)
        x = x + SH.einsum("bshk,hkd->bsd", out,
                             p["xattn"]["wo"].to(x.dtype))
        h = C.layer_norm(x, p["ln2"], p["ln2b"], cfg.norm_eps)
        x = x + C.mlp(p["mlp"], h, cfg)
    x = C.layer_norm(x, params["final_norm"], params["final_norm_b"],
                     cfg.norm_eps)
    new_cache = dict(cache, kv=_stack(kvs),
                     pos=torch.tensor(pos + 1, dtype=torch.int32))
    return C.unembed(params["embed"], x, cfg)[:, 0], new_cache


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: a dict is a submodule, a
    tensor an ``nn.Parameter`` (the tensor itself, not a copy)."""

    def __init__(self, tree: Params):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def tree(self) -> Params:
        """The nested dict of this module's parameters."""
        out: Params = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


class LM(ParamTree):
    """A language model of any family.

    ``LM(cfg, generator=g, device="cuda")`` draws fresh parameters from
    ``g`` (a generator on the device); ``LM(cfg, params=tree)`` adopts a
    tree (:func:`repro_torch.convert.lm_params_from_numpy` builds one
    from the reference's parameters).  Whisper (family ``encdec``) runs
    through the ``whisper_*`` methods.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        if params is None:
            from repro_torch.engine.plan import resolve_device
            dev = resolve_device(device)
            if generator is None:
                raise ValueError("LM needs params= or a generator= on the "
                                 "device to draw them from")
            params = init_params(generator, cfg, dev)
        super().__init__(params)
        self.cfg = cfg

    def forward_hidden(self, tokens, *, embeds=None, remat=True):
        return forward_hidden(self.tree(), tokens, self.cfg, embeds=embeds,
                              remat=remat)

    def forward(self, tokens, *, embeds=None, remat=True):
        return forward(self.tree(), tokens, self.cfg, embeds=embeds,
                       remat=remat)

    def prefill(self, tokens, max_len: int, *, embeds=None, remat=True):
        return prefill(self.tree(), tokens, self.cfg, max_len,
                       embeds=embeds, remat=remat)

    def init_decode_cache(self, batch: int, max_len: int):
        return init_decode_cache(self.cfg, batch, max_len,
                                 device=self.final_norm.device)

    def decode_step(self, cache, tokens):
        return decode_step(self.tree(), cache, tokens, self.cfg)

    def whisper_forward(self, enc_embeds, dec_tokens, remat=True):
        return whisper_forward(self.tree(), enc_embeds, dec_tokens, self.cfg,
                               remat)

    def whisper_prefill(self, enc_embeds):
        return whisper_prefill(self.tree(), enc_embeds, self.cfg,
                               enc_embeds.shape[0])

    def whisper_decode_step(self, cache, tokens):
        return whisper_decode_step(self.tree(), cache, tokens, self.cfg)
