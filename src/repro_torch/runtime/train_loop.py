"""Training loop with checkpoint/restart and async saves (the port's copy
of ``repro.runtime.train_loop``).

All the work is in the step functions (:mod:`repro_torch.runtime.steps`)
and the substrate (checkpointer, pipeline).  Restart-safety contract:
state(t+1) = f(state(t), batch(t)) with batch(t) a pure function of
(seed, t), so a crash and a restore of step k replay exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import Pipeline
from repro_torch.engine.plan import resolve_device
from repro_torch.runtime import steps as ST


@dataclasses.dataclass
class TrainResult:
    final_loss: float
    losses: list
    steps_run: int
    restored_from: Optional[int]
    state: Optional[ST.TrainState] = None


def train(cfg: ModelConfig, run: RunConfig, pipeline: Pipeline,
          shape: ShapeConfig, num_steps: int,
          log_every: int = 10,
          on_step: Optional[Callable[[int, Dict], None]] = None,
          resume: bool = True, device="cuda") -> TrainResult:
    """Train ``num_steps`` steps on ``device`` (resuming from the newest
    committed checkpoint in ``run.checkpoint_dir`` when ``resume``).

    Parameters start from ``torch.Generator(device).manual_seed(run.seed)``.
    A checkpoint is saved asynchronously every ``run.checkpoint_every``
    steps and synchronously at the end.  The final state is returned in
    ``TrainResult.state``.
    """
    dev = resolve_device(device)
    ck = Checkpointer(run.checkpoint_dir, keep=run.keep_checkpoints)
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    state = ST.init_train_state(gen, cfg, run, device=dev)

    restored_from = None
    if resume and ck.latest_step() is not None:
        state, restored_from = ck.restore(state)

    losses = []
    start = int(state.step)
    t0 = time.time()
    for step in range(start, num_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch_at(step, shape).items()}
        state, metrics = ST.train_step(state, batch, cfg, run)
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step:
            on_step(step, metrics)
        if log_every and (step % log_every == 0 or step == num_steps - 1):
            dt = time.time() - t0
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"({dt:.1f}s)", flush=True)
        if run.checkpoint_every and step > 0 \
                and step % run.checkpoint_every == 0:
            ck.save_async(step, state)
    ck.wait()
    if num_steps > start:
        ck.save(num_steps, state)
    return TrainResult(final_loss=losses[-1] if losses else float("nan"),
                       losses=losses, steps_run=num_steps - start,
                       restored_from=restored_from, state=state)
