"""Pixtral-12B — VLM: Pixtral-ViT frontend + Mistral-NeMo-style decoder.
[hf mistralai/Pixtral-12B-2409]

Backbone only per the assignment: 40 layers, d_model 5120, 32 heads
(GQA kv=8), ffn 14336, vocab 131072.  The ViT frontend is a STUB:
``input_specs`` provides precomputed patch embeddings that replace the
leading token positions (train_4k uses 1024 patch positions).
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    frontend_stub=True,
)

SMOKE = ModelConfig(
    arch_id="pixtral-12b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    frontend_stub=True,
)

RUN = RunConfig(grad_accum=8)
