"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``):
the reference's tests (``tests/test_checkpoint.py``) for the port, and
the on-disk format across packages: a checkpoint written by either
restores in the other (leaf order, manifest paths, bfloat16 bytes), and
a training state the reference wrote restores in the port and trains
on as the reference's does.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.configs import registry as RR
from repro.configs.base import ShapeConfig as RShape
from repro.configs.qwen2_0_5b import FULL as R_QWEN, RUN as R_RUN
from repro.data import pipeline as RP
from repro.runtime import steps as RS

from repro_torch import convert, pytree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as PR
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.qwen2_0_5b import FULL as P_QWEN
from repro_torch.runtime import steps as PS

NARROW = dict(n_layers=2, d_model=112, d_ff=192, vocab_size=1000,
              dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.standard_normal((8, 4)),
                                     dtype=torch.float32),
                   "b": torch.tensor(rng.standard_normal(4),
                                     dtype=torch.bfloat16)},
        "step": torch.tensor(17, dtype=torch.int32),
    }


def _zeros_like(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(100, tree)
    restored, step = ck.restore(_zeros_like(tree))
    assert step == 100
    for a, b in zip(pytree.leaves(tree), pytree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _tree())
    broken = tmp_path / "step_000000009"
    broken.mkdir()
    (broken / "MANIFEST.json").write_text("{}")
    assert ck.latest_step() == 5


def test_gc_keeps_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    names = sorted(p.name for p in tmp_path.glob("step_*"))
    assert names == ["step_000000003", "step_000000004"]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(7, _tree())
    ck.wait()
    assert ck.latest_step() == 7


def test_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(ValueError):
        ck.restore({"only_one_leaf": torch.zeros(3)})


def test_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 9))
    with pytest.raises(ValueError):
        ck.restore(bad)


def test_restore_latest_of_many(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (10, 30, 20):
        ck.save(s, _tree(s))
    _, step = ck.restore(_zeros_like(_tree()))
    assert step == 30


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _jax_tree(tree):
    return jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype),
        tree)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_format_crosses_packages(tmp_path, writer):
    tree = _tree(3)
    if writer == "reference":
        RCheckpointer(str(tmp_path)).save(4, _jax_tree(tree))
        restored, step = Checkpointer(str(tmp_path)).restore(
            _zeros_like(tree))
        got = pytree.leaves(restored)
    else:
        Checkpointer(str(tmp_path)).save(4, tree)
        restored, step = RCheckpointer(str(tmp_path)).restore(
            jax.tree_util.tree_map(jnp.zeros_like, _jax_tree(tree)))
        got = [torch.from_numpy(np.asarray(a, np.float32))
               for a in jax.tree_util.tree_leaves(restored)]
        assert [str(a.dtype) for a in jax.tree_util.tree_leaves(restored)] \
            == ["bfloat16", "float32", "int32"]
    assert step == 4
    for want, have in zip(pytree.leaves(tree), got):
        assert torch.equal(want.float(), have.float())
    # the reference names the leaves as the port does
    manifest = json.loads(
        (tmp_path / "step_000000004" / "MANIFEST.json").read_text())
    assert manifest["paths"] == ["['params']['b']", "['params']['w']",
                                 "['step']"]
    assert manifest["shapes"] == [[4], [8, 4], []]
    assert manifest["dtypes"] == ["bfloat16", "float32", "int32"]


def _narrow(compression):
    rc = dataclasses.replace(R_QWEN, **NARROW)
    pc = dataclasses.replace(P_QWEN, **NARROW)
    rrun = dataclasses.replace(R_RUN, grad_accum=1,
                               grad_compression=compression, warmup_steps=2)
    return rc, pc, rrun, RunConfig(**dataclasses.asdict(rrun))


def test_reference_train_state_restores_with_its_paths(tmp_path):
    """A compressed run's state (params, opt.count/mu/nu, efb, step) made
    by the reference restores in the port leaf for leaf, into a template
    the port made itself, and the port writes the same manifest back."""
    rc, pc, rrun, prun = _narrow("dwt:2")
    state = RS.init_train_state(jax.random.PRNGKey(1), rc, rrun)
    state = state._replace(
        step=jnp.asarray(5, jnp.int32),
        efb=jax.tree_util.tree_map(lambda a: a + 0.25, state.efb))
    RCheckpointer(str(tmp_path / "ref")).save(5, state)
    template = PS.init_train_state(torch.Generator().manual_seed(0), pc,
                                   prun, device="cpu")
    restored, step = Checkpointer(str(tmp_path / "ref")).restore(template)
    assert step == 5 and int(restored.step) == 5
    assert all(p.requires_grad for p in pytree.leaves(restored.params))
    for want, have in zip(jax.tree_util.tree_leaves(state),
                          pytree.leaves(restored)):
        assert np.array_equal(np.asarray(want), have.detach().numpy())
    Checkpointer(str(tmp_path / "port")).save(5, restored)
    ref_m, port_m = (json.loads((tmp_path / d / "step_000000005" /
                                 "MANIFEST.json").read_text())
                     for d in ("ref", "port"))
    assert ref_m == port_m


def test_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """The reference trains one step and saves; the port restores and
    takes step 2, as the reference does from the same state."""
    rc, pc, rrun, prun = _narrow("none")
    step = jax.jit(RS.train_step, static_argnames=("cfg", "run"))
    batch = lambda i: RP.make_pipeline(rc, seed=0).batch_at(
        i, RShape("s", "train", 32, 4))
    state = RS.init_train_state(jax.random.PRNGKey(0), rc, rrun)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in batch(0).items()},
                    cfg=rc, run=rrun)
    RCheckpointer(str(tmp_path)).save(1, state)
    want_state, want = step(
        state, {k: jnp.asarray(v) for k, v in batch(1).items()}, cfg=rc,
        run=rrun)
    template = PS.init_train_state(torch.Generator().manual_seed(0), pc,
                                   prun, device="cpu")
    pstate, _ = Checkpointer(str(tmp_path)).restore(template)
    pstate, got = PS.train_step(
        pstate, {k: torch.from_numpy(v) for k, v in batch(1).items()}, pc,
        prun)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert int(pstate.step) == int(want_state.step) == 2
    for a, b in zip(jax.tree_util.tree_leaves(want_state.params),
                    pytree.leaves(pstate.params)):
        assert float(np.abs(np.asarray(a) - b.detach().numpy()).max()) \
            <= rrun.lr


@pytest.mark.parametrize("arch,marker", [("zamba2-2.7b", "['shared_attn']"),
                                         ("whisper-medium", "['dec_blocks']")])
def test_reference_train_state_of_other_trees_restores(tmp_path, arch,
                                                       marker):
    """A compressed run's state of zamba2 (its unstacked ``shared_attn``)
    and of whisper (``enc_blocks``/``dec_blocks``) as the reference's
    ``TrainState`` (values drawn by the port: the reference's init
    compiles op by op), written by the reference's checkpointer, restores
    in the port leaf for leaf into a template the port made, equals what
    ``convert.train_state_from_numpy`` carries across, and the port
    writes the same manifest back."""
    from repro.optim import adamw as RA
    _, rrun = RR.get_config(arch, smoke=True)
    pc, _ = PR.get_config(arch, smoke=True)
    rrun = dataclasses.replace(rrun, grad_compression="dwt:2")
    prun = RunConfig(**dataclasses.asdict(rrun))
    drawn = PS.init_train_state(torch.Generator().manual_seed(2), pc, prun,
                                device="cpu")
    arrays = lambda tree: jax.tree_util.tree_map(
        jnp.asarray, pytree.tree_map(lambda t: t.detach().numpy(), tree))
    state = RS.TrainState(
        params=arrays(drawn.params),
        opt=RA.AdamWState(count=jnp.asarray(3, jnp.int32),
                          mu=arrays(drawn.opt.mu), nu=arrays(drawn.opt.nu)),
        efb=jax.tree_util.tree_map(lambda a: a + 0.25, arrays(drawn.efb)),
        step=jnp.asarray(5, jnp.int32))
    RCheckpointer(str(tmp_path / "ref")).save(5, state)
    template = PS.init_train_state(torch.Generator().manual_seed(0), pc,
                                   prun, device="cpu")
    restored, step = Checkpointer(str(tmp_path / "ref")).restore(template)
    carried = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), pc, device="cpu")
    assert step == 5 and int(restored.step) == 5 == int(carried.step)
    for want, have, conv in zip(jax.tree_util.tree_leaves(state),
                                pytree.leaves(restored),
                                pytree.leaves(carried)):
        assert np.array_equal(np.asarray(want), have.detach().numpy())
        assert torch.equal(have.detach(), conv.detach())
    Checkpointer(str(tmp_path / "port")).save(5, restored)
    ref_m, port_m = (json.loads((tmp_path / d / "step_000000005" /
                                 "MANIFEST.json").read_text())
                     for d in ("ref", "port"))
    assert ref_m == port_m
    assert any(p.startswith(".params" + marker) for p in ref_m["paths"])


def test_moe_restart_replays_its_loss(tmp_path):
    """``train_loop.train`` of mixtral's SMOKE (compressed, 3 steps,
    checkpoints every step); a run restarted from the checkpoint saved
    after its second step takes the third with the uninterrupted run's
    loss, bit for bit."""
    import os
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.runtime import train_loop as PT
    pc, prun = PR.get_config("mixtral-8x7b", smoke=True)
    run = dataclasses.replace(prun, grad_compression="dwt:2",
                              checkpoint_every=1, keep_checkpoints=5,
                              checkpoint_dir=str(tmp_path / "a"))
    shape = ShapeConfig("s", "train", 16, 4)
    pipe = make_pipeline(pc, seed=0)
    first = PT.train(pc, run, pipe, shape, 3, log_every=0, device="cpu")
    (tmp_path / "b").mkdir()
    os.symlink(tmp_path / "a" / "step_000000001",
               tmp_path / "b" / "step_000000001")
    again = PT.train(pc, dataclasses.replace(
        run, checkpoint_dir=str(tmp_path / "b")), pipe, shape, 3,
        log_every=0, device="cpu")
    assert again.restored_from == 1 and len(again.losses) == 1
    assert again.losses == first.losses[2:]
    assert float(first.state.params["blocks"]["moe"]["gate"].abs().max()) > 0
