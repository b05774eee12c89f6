"""RWKV6-3B ("Finch") — attention-free RNN with data-dependent decay.
[arXiv:2404.05892; hf RWKV/rwkv-6-world-3b]

32 layers, d_model 2560 (40 heads of 64), channel-mix ffn 8960,
vocab 65536.  Recurrent state (per-head 64x64 wkv matrix + token-shift
vectors) makes decode O(1) per token — runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model / 64
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    rope_theta=0.0,
)

SMOKE = ModelConfig(
    arch_id="rwkv6-3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,           # 2 rwkv heads of 64
    n_heads=2,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope_theta=0.0,
)

RUN = RunConfig(grad_accum=4)
