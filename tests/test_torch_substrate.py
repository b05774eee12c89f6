"""The port's training substrate against the reference's: the data
pipeline (``repro_torch.data.pipeline``), AdamW (``repro_torch.optim``),
the chunked CE and the train step (``repro_torch.runtime.steps``) and
the train loop (``repro_torch.runtime.train_loop``).

AdamW on the same inputs is held per leaf to 1e-6 of the leaf's largest
reference value (the same float32 ops in the same order, but the global
norm sums in another order).  The composed train step is in
``test_torch_train_step.py``.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as RR
from repro.configs.base import (TRAIN_4K, RunConfig as RRun,
                                ShapeConfig as RShape)
from repro.data import pipeline as RP
from repro.optim import adamw as RA

from repro_torch import pytree
from repro_torch.configs import registry as PR
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline as PP
from repro_torch.models import common as PC
from repro_torch.models import lm as PL
from repro_torch.optim import adamw as PA
from repro_torch.runtime import steps as PS
from repro_torch.runtime import train_loop as PT

ROOT = Path(__file__).resolve().parents[1]
DENSE_VLM = [a for a in RR.ARCH_IDS
             if RR.get_config(a)[0].family in ("dense", "vlm")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_leaves_close(ref_tree, got_tree, rtol):
    ref = jax.tree_util.tree_leaves(ref_tree)
    got = pytree.leaves(got_tree)
    assert len(ref) == len(got)
    for want, have in zip(ref, got):
        want, have = np.asarray(want, np.float64), _np(have).astype(
            np.float64)
        assert want.shape == have.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(want - have).max()) <= rtol * scale


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_VLM)
def test_batch_at_equals_the_reference_bit_for_bit(arch):
    for smoke in (False, True):
        rc, pc = RR.get_config(arch, smoke)[0], PR.get_config(arch, smoke)[0]
        for shard, num in ((0, 1), (3, 8)):
            ref = RP.make_pipeline(rc, seed=7, shard=shard, num_shards=num)
            got = PP.make_pipeline(pc, seed=7, shard=shard, num_shards=num)
            for step, (s, b) in ((0, (64, 8)), (41, (1024, 2))):
                want = ref.batch_at(step, RShape("s", "train", s, b))
                have = got.batch_at(step, ShapeConfig("s", "train", s, b))
                assert sorted(want) == sorted(have)
                for k in want:
                    assert want[k].dtype == have[k].dtype
                    np.testing.assert_array_equal(want[k], have[k])
    # iterating yields train_4k batches from step 0 (the port's own config)
    np.testing.assert_array_equal(
        next(iter(PP.make_pipeline(pc, seed=1)))["tokens"],
        RP.make_pipeline(rc, seed=1).batch_at(0, TRAIN_4K)["tokens"])


_BIN_PROBE = """
import sys
from repro_torch.data.pipeline import BinTokenSource
src = BinTokenSource(sys.argv[1], vocab_size=500)
print(src.tokens(3, 1, 2, 8).tolist())
"""


def test_bin_source_replays_the_same_batches_in_every_process(tmp_path):
    """``batch_at`` is a pure function of (path, step, shard): two
    processes with different str-hash salts read the same tokens (the
    reference's ``hash(path)`` seed does not; the port's is a CRC-32)."""
    path = tmp_path / "corpus.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    outs = []
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=salt)
        out = subprocess.run([sys.executable, "-c", _BIN_PROBE, str(path)],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout)
    assert outs[0] == outs[1] and outs[0].startswith("[[")
    assert PP.path_seed(str(path)) == PP.path_seed(str(path))


def test_pipeline_deterministic_resume():
    cfg, _ = PR.get_config("minitron-8b", smoke=True)
    shape = ShapeConfig("s", "train", 64, 8)
    b1 = PP.make_pipeline(cfg, seed=7, shard=3, num_shards=8).batch_at(41,
                                                                      shape)
    b2 = PP.make_pipeline(cfg, seed=7, shard=3, num_shards=8).batch_at(41,
                                                                      shape)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    a = PP.make_pipeline(cfg, seed=7, shard=0, num_shards=8).batch_at(5,
                                                                     shape)
    b = PP.make_pipeline(cfg, seed=7, shard=1, num_shards=8).batch_at(5,
                                                                     shape)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_pipeline_tokens_in_range():
    cfg, _ = PR.get_config("qwen2-0.5b", smoke=True)
    b = PP.make_pipeline(cfg, seed=0).batch_at(
        0, ShapeConfig("s", "train", 128, 4))
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < cfg.vocab_size


# ---------------------------------------------------------------------------
# AdamW (the reference's tests, for the port) and its parity
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    run = RunConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                    total_steps=10_000)
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3, requires_grad=True)}
    state = PA.init(params)
    for _ in range(300):
        loss = torch.sum((params["w"] - target) ** 2)
        g = {"w": torch.autograd.grad(loss, params["w"])[0]}
        params, state, _ = PA.apply(g, state, params, run)
        params = {"w": params["w"].requires_grad_(True)}
    np.testing.assert_allclose(_np(params["w"]), _np(target), atol=0.05)


def test_lr_schedule():
    run = RunConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    assert float(PA.cosine_lr(torch.tensor(0), run)) == 0.0
    assert abs(float(PA.cosine_lr(torch.tensor(10), run)) - 1e-3) < 1e-9
    assert float(PA.cosine_lr(torch.tensor(100), run)) < 1e-8
    rrun = RRun(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 7, 10, 11, 55, 99, 100, 150):
        assert float(PA.cosine_lr(torch.tensor(step), run)) == float(
            RA.cosine_lr(jnp.asarray(step), rrun))


def test_grad_clipping():
    run = RunConfig(lr=1e-2, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = PA.init(params)
    g = {"w": torch.full((4,), 1e6)}
    _, _, m = PA.apply(g, state, params, run, clip_norm=1.0)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_adamw_apply_matches_reference_on_the_same_inputs():
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 2, 4)}}
    tree = lambda scale: jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, grads, mu = tree(1.0), tree(0.3), tree(0.01)
    nu = jax.tree_util.tree_map(np.abs, tree(1e-3))
    run = dict(lr=1e-3, warmup_steps=3, total_steps=20, weight_decay=0.1)
    rstate = RA.AdamWState(jnp.asarray(4, jnp.int32),
                           jax.tree_util.tree_map(jnp.asarray, mu),
                           jax.tree_util.tree_map(jnp.asarray, nu))
    conv = lambda t: pytree.tree_map(lambda a: torch.from_numpy(a), t)
    pstate = PA.AdamWState(torch.tensor(4, dtype=torch.int32), conv(mu),
                           conv(nu))
    for clip in (1.0, 100.0):   # clipping active, then not
        want = RA.apply(jax.tree_util.tree_map(jnp.asarray, grads), rstate,
                        jax.tree_util.tree_map(jnp.asarray, params),
                        RRun(**run), clip_norm=clip)
        got = PA.apply(conv(grads), pstate, conv(params), RunConfig(**run),
                       clip_norm=clip)
        assert_leaves_close(want[0], got[0], rtol=1e-6)
        assert_leaves_close(want[1].mu, got[1].mu, rtol=1e-6)
        assert_leaves_close(want[1].nu, got[1].nu, rtol=1e-6)
        assert int(got[1].count) == 5
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# Chunked CE
# ---------------------------------------------------------------------------

def test_chunked_ce_matches_direct():
    cfg, _ = PR.get_config("minitron-8b", smoke=True)
    rng = np.random.default_rng(0)
    b, s = 2, 64
    hidden = torch.tensor(rng.standard_normal((b, s, cfg.d_model)) * 0.3,
                          dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)))
    mask = torch.ones((b, s), dtype=torch.float32)
    params = PL.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ce = PS.chunked_ce(params["embed"], hidden, labels, mask, cfg, chunk=16)
    logits = PC.unembed(params["embed"], hidden, cfg).float()
    direct = -torch.mean(torch.gather(torch.log_softmax(logits, -1), -1,
                                      labels[..., None]))
    np.testing.assert_allclose(float(ce), float(direct), rtol=1e-4)


# ---------------------------------------------------------------------------
# The train loop: restart replays bit for bit
# ---------------------------------------------------------------------------

def test_train_resumes_with_bit_equal_losses(tmp_path):
    cfg, run = PR.get_config("qwen2-0.5b", smoke=True)
    run = dataclasses.replace(run, checkpoint_every=1, keep_checkpoints=5,
                              checkpoint_dir=str(tmp_path / "a"),
                              grad_compression="dwt:2")
    shape = ShapeConfig("s", "train", 32, 4)
    pipe = PP.make_pipeline(cfg, seed=0)
    full = PT.train(cfg, run, pipe, shape, 4, log_every=0, device="cpu")
    assert full.restored_from is None and len(full.losses) == 4
    assert all(np.isfinite(full.losses))
    # a job killed after step 1's checkpoint restarts from it
    b = tmp_path / "b"
    b.mkdir()
    shutil.copytree(tmp_path / "a" / "step_000000001",
                    b / "step_000000001")
    again = PT.train(cfg, dataclasses.replace(run, checkpoint_dir=str(b)),
                     pipe, shape, 4, log_every=0, device="cpu")
    assert again.restored_from == 1
    assert again.losses == full.losses[2:]
    for x, y in zip(pytree.leaves(full.state), pytree.leaves(again.state)):
        assert torch.equal(x.detach(), y.detach())


def test_tree_walks_hold_no_leaf_after_they_return():
    """``leaves`` and ``unflatten`` leave no reference cycle behind: with
    the cyclic collector off, a leaf is freed as soon as the caller drops
    it (a recursive closure once kept every walked parameter tree alive
    until the collector ran, tens of GiB on the card at mixtral's width)."""
    import gc
    import weakref
    from repro_torch import pytree
    was = gc.isenabled()
    gc.disable()
    try:
        t = torch.zeros(3)
        ref = weakref.ref(t)
        walked = pytree.leaves({"a": t, "b": [t, (t, None)]})
        rebuilt = pytree.unflatten({"x": [0, {"y": 0}]}, [t, t])
        assert len(walked) == 3 and rebuilt["x"][1]["y"] is t
        del t, walked, rebuilt
        assert ref() is None
    finally:
        if was:
            gc.enable()


_FIRST_STEP = """
import dataclasses, gc
import torch
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.runtime import steps
cfg, run = get_config("qwen2-0.5b", smoke=True)
run = dataclasses.replace(run, grad_compression="dwt:2", grad_accum=1)
state = steps.init_train_state(torch.Generator().manual_seed(0), cfg, run,
                               device="cpu")
batch = {k: torch.from_numpy(v) for k, v in make_pipeline(cfg).batch_at(
    0, ShapeConfig("s", "train", 32, 4)).items()}
gc.collect()
gc.disable()
state, _ = steps.train_step(state, batch, cfg, run)
gc.set_debug(gc.DEBUG_SAVEALL)
gc.collect()
held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
print("TENSORS_IN_CYCLES", len(held))
"""


def test_first_train_step_leaves_no_tensor_in_a_cycle():
    """The first train step of a fresh process (where
    ``torch.utils.checkpoint`` first imports ``torch._dynamo``) leaves no
    tensor in cyclic garbage: every gradient and old state tree is freed
    when the caller drops it, not when the collector runs."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _FIRST_STEP],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "TENSORS_IN_CYCLES 0" in out.stdout, out.stdout
