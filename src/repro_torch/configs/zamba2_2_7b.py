"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf Zyphra/Zamba2-2.7B]

54 Mamba2 layers (d_model 2560, state 64), with a single *shared*
attention+MLP block (32 heads) invoked every 6 backbone layers.  (The
published model adds per-invocation LoRA deltas on the shared block; we
share the full block — noted in DESIGN.md.)  SSM state makes long_500k
O(1) per token.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    hybrid_period=6,
)

SMOKE = ModelConfig(
    arch_id="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=32,
    hybrid_period=2,
)

RUN = RunConfig(grad_accum=8)
