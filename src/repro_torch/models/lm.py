"""Language-model assembly for the dense and VLM families (the port's
copy of the dense/VLM parts of ``repro.models.lm``).

Parameters keep the reference's layout: a nested dict with one tensor per
leaf and the layers stacked on a leading ``n_layers`` axis
(``blocks.attn.wq`` is ``(n_layers, d_model, n_heads_padded, head_dim)``).
The layout is not cosmetic: gradient compression works per leaf, and a
stacked leaf pads and wraps into other ``(H, 256)`` tiles than per-layer
tensors would; the same layout makes a checkpoint's leaves the
reference's.  The block loop indexes the stacked leaves (one ``unbind``
per leaf, so the backward pass stacks the layers' gradients once), and
each block runs under ``torch.utils.checkpoint`` when ``remat`` is on, as
the reference's ``jax.checkpoint`` of the scanned block.

:class:`LM` is the ``nn.Module`` face: it registers the tree's leaves as
parameters (``named_parameters()`` gives ``blocks.attn.wq``) and calls
the functions below.  Families other than ``dense`` and ``vlm`` raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import common as C

Params = Dict[str, Any]

FAMILIES = ("dense", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported yet (the "
            f"port runs {FAMILIES}); MoE, SSM, hybrid and encdec models "
            f"come with ROADMAP.md Queue 1 item 11b")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Fresh parameters on ``device``, drawn from ``gen`` (a generator on
    that device)."""
    check_family(cfg)
    n, d, dt = cfg.n_layers, cfg.d_model, C.pdtype(cfg)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    return {
        "embed": C.init_embed(gen, cfg, device),
        "blocks": {
            "ln1": ones(n, d),
            "attn": A.init_attention(gen, cfg, n, device),
            "ln2": ones(n, d),
            "mlp": C.init_mlp(gen, cfg, n, device),
        },
        "final_norm": ones(d),
    }


def layers(blocks: Params) -> List[Params]:
    """The stacked block tree as one tree per layer (views)."""
    flat = [t.unbind(0) for t in pytree.leaves(blocks)]
    return [pytree.unflatten(blocks, [f[i] for f in flat])
            for i in range(len(flat[0]))]


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + A.attend(p["attn"], h, cfg)
    h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + C.mlp(p["mlp"], h, cfg)


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
    check_family(cfg)
    x = _embed(params, tokens, cfg, embeds)
    for p in layers(params["blocks"]):
        if remat:
            x = checkpoint(_block_fwd, p, x, cfg, use_reentrant=False)
        else:
            x = _block_fwd(p, x, cfg)
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal LM forward: (B, S) -> (logits (B, S, Vp), aux_loss)."""
    x, aux = forward_hidden(params, tokens, cfg, embeds=embeds, remat=remat)
    return C.unembed(params["embed"], x, cfg), aux


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, *, embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, Params]:
    """Returns (last-position logits (B, Vp), decode cache at pos=S)."""
    check_family(cfg)
    b, s = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, cfg, embeds)

    def body(p, x):
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, kv = A.prefill_attend(
            p["attn"], A.init_cache(cfg, b, max_len, device=dev), h, cfg)
        x = x + y
        h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + C.mlp(p["mlp"], h, cfg), kv["k"], kv["v"]

    ks, vs = [], []
    for p in layers(params["blocks"]):
        if remat and torch.is_grad_enabled():
            x, k, v = checkpoint(body, p, x, use_reentrant=False)
        else:
            x, k, v = body(p, x)
        ks.append(k)
        vs.append(v)
    cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "pos": torch.tensor(s, dtype=torch.int32)}
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Params:
    """Stacked per-layer KV caches at position 0, on ``device``."""
    from repro_torch.engine.plan import resolve_device
    check_family(cfg)
    one = A.init_cache(cfg, batch, max_len, device=resolve_device(device))
    n = cfg.n_layers
    return {"kv": {k: v.expand((n,) + v.shape).clone()
                   for k, v in one.items()},
            "pos": torch.tensor(0, dtype=torch.int32)}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) int.  Returns (logits (B, Vp),
    new cache); ``cache`` is left as it was."""
    check_family(cfg)
    pos = int(cache["pos"])
    x = C.embed(params["embed"], tokens, cfg)
    ks, vs = [], []
    for i, p in enumerate(layers(params["blocks"])):
        h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
        y, kv = A.decode_attend(p["attn"], {"k": cache["kv"]["k"][i],
                                            "v": cache["kv"]["v"][i]},
                                h, pos, cfg)
        x = x + y
        h = C.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + C.mlp(p["mlp"], h, cfg)
        ks.append(kv["k"])
        vs.append(kv["v"])
    new_cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "pos": torch.tensor(pos + 1, dtype=torch.int32)}
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
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
    """A dense or VLM language model.

    ``LM(cfg, generator=g, device="cuda")`` draws fresh parameters from
    ``g`` (a generator on the device); ``LM(cfg, params=tree)`` adopts a
    tree (:func:`repro_torch.convert.lm_params_from_numpy` builds one
    from the reference's parameters).
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        check_family(cfg)
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
