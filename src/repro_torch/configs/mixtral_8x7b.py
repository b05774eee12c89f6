"""Mixtral-8x7B — sparse MoE (8 experts, top-2) with sliding-window
attention.  [arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1]

SWA window 4096 bounds the decode KV cache to the window (ring buffer),
which makes the long_500k cell legitimately sub-quadratic for this arch.
Expert FFNs are tensor-sharded on d_ff (8 experts do not divide the
16-way axis, so EP is not offered here; see dbrx for EP).
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
)

SMOKE = ModelConfig(
    arch_id="mixtral-8x7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    sliding_window=16,
    n_experts=4,
    top_k=2,
)

RUN = RunConfig(grad_accum=4)
