"""Meta-device input specs for every (architecture x shape) cell: the
port's copy of ``repro.launch.specs``.

Nothing here allocates memory: batches, parameter trees, optimizer
states and decode caches are tensors on the ``meta`` device, with the
reference's dtypes (int32 tokens, bfloat16 embeddings) and tree
structures, where the reference uses ``jax.eval_shape``.  The modality
frontends of whisper/pixtral are stubs — their specs are precomputed
frame/patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import compression as CMP
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps

META = torch.device("meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Input-batch stand-ins for one shape cell."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda *dims: torch.empty(dims, dtype=torch.int32, device=META)
    emb = lambda *dims: torch.empty(dims, dtype=torch.bfloat16, device=META)

    if cfg.family == "encdec":
        if shape.kind == "train":
            return {"enc_embeds": emb(b, s, cfg.d_model),
                    "dec_tokens": tok(b, cfg.max_target_len)}
        if shape.kind == "prefill":
            return {"enc_embeds": emb(b, s, cfg.d_model)}
        return {"tokens": tok(b, 1)}

    if shape.kind == "decode":
        return {"tokens": tok(b, 1)}
    batch: Dict[str, Any] = {"tokens": tok(b, s)}
    if cfg.family == "vlm" and cfg.frontend_stub and shape.kind == "train":
        batch["patch_embeds"] = emb(b, min(1024, s // 4), cfg.d_model)
    return batch


def params_specs(cfg: ModelConfig):
    return lm.init_params(None, cfg, META)


def state_specs(cfg: ModelConfig, run: RunConfig) -> steps.TrainState:
    """A TrainState of meta tensors (the step counters on the host, as
    the port keeps them)."""
    params = params_specs(cfg)
    efb = (CMP.init_error_feedback(params)
           if run.grad_compression.startswith("dwt") else {})
    return steps.TrainState(params, adamw.init(params), efb,
                            torch.tensor(0, dtype=torch.int32))


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return lm.init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                device=META)


def input_specs(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig
                ) -> Tuple[Any, ...]:
    """All inputs for the step function this cell runs.

    train  -> (TrainState, batch)
    prefill-> (params, batch)
    decode -> (params, cache, tokens)
    """
    if shape.kind == "train":
        return (state_specs(cfg, run), batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return (params_specs(cfg), batch_specs(cfg, shape))
    return (params_specs(cfg), cache_specs(cfg, shape),
            batch_specs(cfg, shape)["tokens"])
