"""Qwen2-0.5B — dense GQA with QKV bias, tied embeddings.
[arXiv:2407.10671; hf Qwen/Qwen2-0.5B]

14 heads is not divisible by the 16-way model axis, and d_model=896 is
tiny, so attention runs with replicated parameters (attn_tp=False); FFN
and vocab are tensor-sharded.  See DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tied_embeddings=True,
    norm_eps=1e-6,
    pad_heads_multiple=16,  # TP alignment: see DESIGN.md
)

SMOKE = ModelConfig(
    arch_id="qwen2-0.5b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    tied_embeddings=True,
)

RUN = RunConfig(attn_tp=True, grad_accum=2)  # 14 q-heads pad to 16 over model
