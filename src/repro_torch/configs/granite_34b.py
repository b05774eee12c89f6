"""Granite-34B-Code — deep MQA (kv=1) code model, llama-style arch.
[arXiv:2405.04324; hf ibm-granite/granite-34b-code-base]

88 layers x d_model 6144, 48 heads with a single shared KV head (MQA):
KV projections are replicated across the model axis (standard MQA TP);
48 query heads shard 3-per-chip on the 16-way axis.  The 88-layer depth
is the scan-over-layers compile-scalability stress test.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49_152,
    rope_theta=10_000.0,
    act="gelu",            # gpt_bigcode-lineage plain MLP (34B total)
)

SMOKE = ModelConfig(
    arch_id="granite-34b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    act="gelu",
)

RUN = RunConfig(grad_accum=16)
