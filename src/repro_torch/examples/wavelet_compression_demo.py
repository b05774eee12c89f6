"""Gradient-compression ablation: train the same model with and without
DWT gradient compression and compare loss trajectories + exchanged bytes.

    PYTHONPATH=src python -m repro_torch.examples.wavelet_compression_demo
    [--steps 120]

The port of ``examples/wavelet_compression_demo.py``, with the same
flags, defaults and lines.  What changed in the port:

* parameters start from a ``torch.Generator`` on the device seeded with
  the run's seed (the reference's ``jax.random`` key; the values
  differ);
* the steps run eagerly on the card (``device="cuda"``), or on the CPU
  with ``device="cpu"``; compression runs K1 on the card;
* each run's final checkpoint is written under ``ckpt_root`` (the
  system's temporary directory by default, as in the reference).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import compression as CMP
from repro_torch.data.pipeline import make_pipeline
from repro_torch.runtime.train_loop import train


def run_one(tag, cfg, run, steps_n, ckpt, device="cuda"):
    run = dataclasses.replace(run, checkpoint_dir=ckpt, checkpoint_every=0,
                              grad_accum=1, lr=1e-3, warmup_steps=10,
                              total_steps=steps_n)
    pipe = make_pipeline(cfg, seed=0)
    shape = ShapeConfig("demo", "train", 128, 8)
    res = train(cfg, run, pipe, shape, num_steps=steps_n, log_every=0,
                resume=False, device=device)
    print(f"{tag:18s} loss: {res.losses[0]:.4f} -> "
          f"{sum(res.losses[-10:]) / 10:.4f}")
    return res.losses


def byte_lines(cfg):
    """The model line and the cross-pod bytes per step, raw and at
    ``dwt:2``; returns the parameter count and both byte counts."""
    n_params = cfg.n_params()
    print(f"model: {cfg.arch_id} ({n_params/1e6:.2f}M params)")
    print(f"cross-pod bytes/step raw: {n_params*4/1e6:.2f}MB  "
          f"dwt:2 -> {n_params*4/16/1e6:.3f}MB "
          f"({CMP.compressed_bytes_ratio(2)*100:.1f}%)\n")
    return dict(n_params=n_params, raw_bytes=n_params * 4,
                dwt2_bytes=n_params * 4 / 16)


def run_demo(steps=120, device="cuda", ckpt_root=None):
    """minitron-8b's SMOKE config trained ``steps`` steps three times:
    uncompressed, at ``dwt:2`` and at ``dwt:1``; returns the byte counts,
    each run's losses and the final-loss gap of each compressed run."""
    cfg, run = get_config("minitron-8b", smoke=True)
    out = byte_lines(cfg)
    root = ckpt_root or tempfile.gettempdir()
    base = run_one("baseline", cfg, run, steps,
                   os.path.join(root, "wcd_base"), device)
    comp = run_one(
        "dwt:2 compressed", cfg,
        dataclasses.replace(run, grad_compression="dwt:2"),
        steps, os.path.join(root, "wcd_comp"), device)
    comp1 = run_one(
        "dwt:1 compressed", cfg,
        dataclasses.replace(run, grad_compression="dwt:1"),
        steps, os.path.join(root, "wcd_comp1"), device)

    gap = (sum(comp[-10:]) - sum(base[-10:])) / 10
    print(f"\nfinal-loss gap (dwt:2 vs baseline): {gap:+.4f} "
          f"(error feedback keeps compressed training convergent; "
          f"16x fewer cross-pod gradient bytes)")
    out.update(losses={"none": base, "dwt:2": comp, "dwt:1": comp1},
               gap_dwt2=gap, gap_dwt1=(sum(comp1[-10:]) - sum(base[-10:]))
               / 10)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    run_demo(args.steps)


if __name__ == "__main__":
    main()
