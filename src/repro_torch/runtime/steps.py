"""Train / prefill / decode steps for every model family (the port's
copy of the single-device parts of ``repro.runtime.steps``).

``train_step``: loss -> grads (autograd, ``grad_accum`` microbatches) ->
optional DWT compression with error feedback -> AdamW.  Cross-entropy
projects to the vocabulary in sequence chunks of ``CE_CHUNK``, each
under ``torch.utils.checkpoint``, so no ``(B, chunk, vocab)`` logits
survive as autograd residuals.

The step is functional, as the reference's: it returns a new
:class:`TrainState` (new parameter, optimizer and error-feedback trees)
and leaves the one it was given as it was.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch import telemetry as T
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import compression as CMP
from repro_torch.models import common as C
from repro_torch.models import lm
from repro_torch.optim import adamw

CE_CHUNK = 256
AUX_COEF = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    efb: Any              # error-feedback state ({} when compression off)
    step: torch.Tensor    # int32, 0-d, on the host


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     run: RunConfig, device="cuda") -> TrainState:
    """Fresh state on ``device``: an :class:`~repro_torch.models.lm.LM`'s
    parameters drawn from ``gen`` (a generator on that device)."""
    params = lm.LM(cfg, generator=gen, device=device).tree()
    efb = (CMP.init_error_feedback(params)
           if run.grad_compression.startswith("dwt") else {})
    return TrainState(params, adamw.init(params), efb,
                      torch.tensor(0, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

def _ce_chunk(embed_params, h, l, m, cfg):
    logits = C.unembed(embed_params, h, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, l[..., None])[..., 0]
    nll = (lse - gold) * m
    return torch.sum(nll), torch.sum(m)


def chunked_ce(embed_params, hidden: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, cfg: ModelConfig,
               chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean CE over masked positions; vocab projection done per chunk.

    hidden: (B, S, D); labels/mask: (B, S).
    """
    b, s, d = hidden.shape
    ch = min(chunk, s)
    while s % ch:
        ch -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, ch):
        t, c = checkpoint(_ce_chunk, embed_params, hidden[:, i:i + ch],
                          labels[:, i:i + ch], mask[:, i:i + ch], cfg,
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            run: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ the MoE aux loss) for every family."""
    remat = run.remat != "none"
    if cfg.family == "encdec":
        hidden, aux = lm.whisper_hidden(params, batch["enc_embeds"],
                                        batch["dec_tokens"], cfg, remat=remat)
        tokens = batch["dec_tokens"]
    else:
        hidden, aux = lm.forward_hidden(params, batch["tokens"], cfg,
                                        embeds=batch.get("patch_embeds"),
                                        remat=remat)
        tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1).long()
    mask = torch.cat(
        [torch.ones(tokens[:, 1:].shape, dtype=torch.float32,
                    device=tokens.device),
         torch.zeros(tokens[:, :1].shape, dtype=torch.float32,
                     device=tokens.device)], dim=1)
    ce = chunked_ce(params["embed"], hidden, labels, mask, cfg)
    loss = ce + AUX_COEF * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


def grads_and_metrics(params, batch, cfg: ModelConfig, run: RunConfig):
    """Gradients (float32 sums over the ``grad_accum`` microbatches, each
    divided by their count) and the **last** microbatch's metrics, as the
    reference's scan gives them."""
    # differentiate with respect to aliases of the leaves, so any tree
    # (an LM's parameters, a step's output, a restored checkpoint) works
    leaves = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    params = pytree.unflatten(params, leaves)
    if run.grad_accum <= 1:
        loss, metrics = lm_loss(params, batch, cfg, run)
        grads = torch.autograd.grad(loss, leaves)
        return pytree.unflatten(params, list(grads)), _detached(metrics)
    n = run.grad_accum
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    metrics = None
    for i in range(n):
        mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, metrics = lm_loss(params, mb, cfg, run)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g.to(torch.float32) / n)
        metrics = _detached(metrics)
    return pytree.unflatten(params, acc), metrics


def compression_levels(run: RunConfig) -> int:
    return int(run.grad_compression.split(":")[1]) \
        if ":" in run.grad_compression else 2


def train_step(state: TrainState, batch, cfg: ModelConfig, run: RunConfig
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on one device (see the module docstring).

    Under ``REPRO_TORCH_TELEMETRY=spans`` the step and its three parts are
    device spans (CUDA events on the card): ``train.step`` around
    ``train.grads``, ``train.compress`` (when compression is on; the DWT
    plans' ``execute.*`` spans nest in it) and ``train.adamw``."""
    dev = pytree.leaves(state.params)[0].device
    with T.device_span("train.step", dev, compression=run.grad_compression):
        with T.device_span("train.grads", dev):
            grads, metrics = grads_and_metrics(state.params, batch, cfg,
                                               run)
        efb = state.efb
        if run.grad_compression.startswith("dwt"):
            with T.device_span("train.compress", dev):
                grads, efb = CMP.compress_with_feedback(
                    grads, efb, state.step, compression_levels(run),
                    run.compression_wavelet)
        with T.device_span("train.adamw", dev):
            params, opt, om = adamw.apply(grads, state.opt, state.params,
                                          run)
    metrics.update(om)
    return TrainState(params, opt, efb, state.step + 1), metrics


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_step(params, batch, cfg: ModelConfig, max_len: int):
    """Full-context prefill -> (last logits, populated decode cache).
    Whisper encodes and computes the cross K/V; its logits are zeros."""
    if cfg.family == "encdec":
        enc = batch["enc_embeds"]
        cache = lm.whisper_prefill(params, enc, cfg, enc.shape[0])
        return torch.zeros((enc.shape[0], C.pad_vocab(cfg.vocab_size)),
                           dtype=torch.float32, device=enc.device), cache
    return lm.prefill(params, batch["tokens"], cfg, max_len,
                      embeds=batch.get("patch_embeds"))


@torch.no_grad()
def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One new token against the cache."""
    if cfg.family == "encdec":
        return lm.whisper_decode_step(params, cache, tokens, cfg)
    return lm.decode_step(params, cache, tokens, cfg)
