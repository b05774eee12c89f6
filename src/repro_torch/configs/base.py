"""Model / run configuration dataclasses.

One ``ModelConfig`` covers all assigned architecture families; family-
specific fields are ignored by other families.  Configs are plain frozen
dataclasses so they hash (usable as static jit args) and print diffably.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # attention
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # partial RoPE (phi-4-mini)
    qkv_bias: bool = False           # qwen2
    sliding_window: Optional[int] = None  # mixtral SWA
    tied_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    # hybrid (zamba2-style): one shared attention block every N ssm blocks
    hybrid_period: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    max_target_len: int = 448
    # vlm / audio stub frontend
    frontend_stub: bool = False      # inputs may be precomputed embeddings
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # TP alignment: pad q-head count to a multiple of this (Megatron-style
    # requirement heads % tp == 0; padded heads are zero-init and
    # mathematically inert at init). 0 = no padding.
    pad_heads_multiple: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        m = self.pad_heads_multiple
        if not m:
            return self.n_heads
        return -(-self.n_heads // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for config
        validation against published sizes."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tied_embeddings else 2)

        def attn_params():
            return d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
                + self.n_heads * hd * d

        def mlp_params(n_copies=1):
            per = 3 * d * f if self.act == "silu" else 2 * d * f
            return per * n_copies

        if self.family in ("dense", "vlm"):
            blk = attn_params() + mlp_params() + 2 * d
            return emb + self.n_layers * blk
        if self.family == "moe":
            blk = attn_params() + mlp_params(self.n_experts) \
                + self.n_experts * d + 2 * d
            return emb + self.n_layers * blk
        if self.family == "ssm":
            # rwkv6: time-mix (~4 d^2 + decay mlps) + channel-mix (~2*d*f)
            blk = 4 * d * d + 2 * d * f + 2 * d
            return emb + self.n_layers * blk
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            shared = attn_params() + mlp_params() + 2 * d
            n_shared = 1
            return emb + self.n_layers * mamba + n_shared * shared
        if self.family == "encdec":
            enc_blk = attn_params() + mlp_params() + 2 * d
            dec_blk = 2 * attn_params() + mlp_params() + 3 * d
            return emb + self.enc_layers * enc_blk + self.dec_layers * dec_blk
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts) — the N in
        MODEL_FLOPS = 6*N_active*D."""
        n = self.n_params()
        if self.is_moe:
            per_expert = (3 * self.d_model * self.d_ff
                          if self.act == "silu" else 2 * self.d_model
                          * self.d_ff)
            n -= self.n_layers * (self.n_experts - self.top_k) * per_expert
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run hyper-parameters + parallelism knobs."""
    # parallelism
    attn_tp: bool = True             # shard heads over "model" (off: qwen2)
    expert_parallel: bool = False    # dbrx EP hillclimb (experts over model)
    remat: str = "block"             # none | block (remat each scanned layer)
    grad_accum: int = 1
    zero: int = 3                    # 3: params FSDP-sharded (re-gathered
                                     # per microbatch); 2: params replicated
                                     # over data, only optimizer state
                                     # sharded (one gather per step)
    seq_parallel: bool = False       # shard activations over model on seq
                                     # between blocks (Korthikanti-style)
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    # gradient compression (the paper's DWT, applied to DP all-reduce)
    grad_compression: str = "none"   # none | dwt:<levels>
    compression_wavelet: str = "cdf97"
    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
