"""Whisper-medium — encoder-decoder audio transformer backbone.
[arXiv:2212.04356]

24+24 layers, d_model 1024, 16 heads (full MHA), ffn 4096, vocab 51865,
LayerNorm + GELU.  The conv/mel frontend is a STUB per the assignment:
``input_specs`` provides precomputed frame embeddings (B, S, d).  Decoder
positions are capped at 448 (the published max_target_positions); decode
shape cells decode one token against a 32k-frame cross-attention cache.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    n_layers=48,           # 24 enc + 24 dec (for bookkeeping)
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    rope_theta=0.0,        # sinusoidal absolute positions, no RoPE
    act="gelu",
    max_target_len=448,
    frontend_stub=True,
)

SMOKE = ModelConfig(
    arch_id="whisper-medium-smoke",
    family="encdec",
    n_layers=4,
    enc_layers=2,
    dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    rope_theta=0.0,
    act="gelu",
    max_target_len=32,
    frontend_stub=True,
)

RUN = RunConfig()
