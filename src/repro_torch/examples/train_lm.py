"""End-to-end example: train a ~100M-param qwen2-family model for a few
hundred steps with the full production stack (pipeline, AdamW,
checkpointing, optional DWT gradient compression).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    [--compress] [--arch qwen2-0.5b]

Loss decreasing on the synthetic bigram-structured stream demonstrates the
whole training path end to end; with --compress, gradients go through the
paper's DWT (LL_2 subband + error feedback; K1 on the card) before the
update.

The port of ``examples/train_lm.py``, with the same flags, defaults and
lines.  What changed in the port:

* parameters start from a ``torch.Generator`` on the device seeded with
  the run's seed (the reference's ``jax.random`` key of the same seed;
  the values differ);
* the step runs eagerly on the card (``device="cuda"``; the reference
  jits it), or on the CPU with ``device="cpu"``;
* the default checkpoint directory is under the system's temporary
  directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.runtime.train_loop import train

# ~100M-param qwen2-family config (scaled-down width/depth, real vocab)
LM100M = ModelConfig(
    arch_id="qwen2-100m",
    family="dense",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=2,
    d_ff=2048,
    vocab_size=65_536,
    qkv_bias=True,
    tied_embeddings=True,
)

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def configs(arch="qwen2-100m", steps=300, compress=False,
            ckpt_dir=CKPT_DIR):
    """The model and run configuration of a training run: ``LM100M``
    with qwen2-0.5b's run settings, or any registry id's SMOKE config."""
    if arch == "qwen2-100m":
        cfg = LM100M
        _, run = get_config("qwen2-0.5b")
    else:
        cfg, run = get_config(arch, smoke=True)
    run = dataclasses.replace(
        run, grad_accum=1, lr=1e-3, warmup_steps=20,
        total_steps=steps, checkpoint_every=100,
        checkpoint_dir=ckpt_dir,
        grad_compression="dwt:2" if compress else "none")
    return cfg, run


def run_training(steps=300, arch="qwen2-100m", batch=8, seq=256,
                 compress=False, ckpt_dir=CKPT_DIR, device="cuda",
                 log_every=20):
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s newest
    checkpoint, as ``train_loop.train`` does); returns the
    :class:`~repro_torch.runtime.train_loop.TrainResult` and the mean
    loss of the first and of the last ten steps."""
    cfg, run = configs(arch, steps, compress, ckpt_dir)
    print(f"arch={cfg.arch_id}  params~{cfg.n_params()/1e6:.1f}M  "
          f"compression={run.grad_compression}")
    shape = ShapeConfig("train_example", "train", seq, batch)
    pipe = make_pipeline(cfg, seed=run.seed)
    res = train(cfg, run, pipe, shape, num_steps=steps, log_every=log_every,
                device=device)

    first = sum(res.losses[:10]) / max(len(res.losses[:10]), 1)
    last = sum(res.losses[-10:]) / max(len(res.losses[-10:]), 1)
    print(f"\nloss: first10={first:.4f} -> last10={last:.4f} "
          f"({'DECREASED' if last < first else 'NO PROGRESS'})")
    return dict(result=res, first10=first, last10=last)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2-100m",
                    help="qwen2-100m or any registry id (smoke config)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--compress", action="store_true",
                    help="DWT gradient compression (levels=2, CDF 9/7)")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)
    run_training(args.steps, args.arch, args.batch, args.seq, args.compress,
                 args.ckpt_dir)


if __name__ == "__main__":
    main()
