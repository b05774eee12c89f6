"""DBRX-132B — fine-grained sparse MoE (16 experts, top-4).
[hf databricks/dbrx-base]

40 layers, d_model 6144, 48 heads (GQA kv=8), expert ffn 10752,
vocab 100352.  16 experts divide the 16-way model axis exactly, so this
arch supports true expert parallelism (experts over "model", all_to_all
dispatch) in addition to the default d_ff tensor sharding — the EP-vs-TP
comparison is one of the §Perf hillclimbs.
"""
from repro_torch.configs.base import ModelConfig, RunConfig

FULL = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    rope_theta=500_000.0,
    n_experts=16,
    top_k=4,
)

SMOKE = ModelConfig(
    arch_id="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    n_experts=4,
    top_k=2,
)

RUN = RunConfig(grad_accum=16)
