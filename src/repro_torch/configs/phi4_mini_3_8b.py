"""Phi-4-mini (3.8B) — dense GQA with partial RoPE and tied embeddings.
[arXiv:2412.08905; hf microsoft/Phi-4-mini-instruct]

24 query heads on a 16-way model axis shard unevenly (GSPMD pads 24->32 on
the head dim; ~33% padding waste on the Q projection only — recorded in
the roofline notes).
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    rope_fraction=0.75,
    tied_embeddings=True,
    pad_heads_multiple=16,  # TP alignment: see DESIGN.md
)

SMOKE = ModelConfig(
    arch_id="phi4-mini-3.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    rope_fraction=0.75,
    tied_embeddings=True,
)

RUN = RunConfig(grad_accum=4)
