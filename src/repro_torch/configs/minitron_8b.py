"""Minitron-8B — width-pruned Nemotron-4 15B.  [arXiv:2407.14679; hf
nvidia/Minitron-8B-Base]

Published config: 32 layers, hidden 4096, 32 heads (GQA kv=8), ffn 16384,
vocab 256000.  Nemotron uses squared-ReLU MLPs; we keep the framework's
SwiGLU (parameter-count neutral at the reported ffn width is documented in
DESIGN.md).  This is the representative dense-DP cell for the DWT
gradient-compression roofline experiment.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256_000,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    arch_id="minitron-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
)

RUN = RunConfig(grad_accum=4)
