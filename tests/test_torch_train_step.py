"""The port's train step (``repro_torch.runtime.steps.train_step``)
against the reference's, in layers, each on the same inputs: loss and
gradients; then three composed steps (grad_accum 1 and 2, compression
"none" and "dwt:2", float32, a narrow qwen2-0.5b) from a state made by
the reference and carried across with ``convert.train_state_from_numpy``
(AdamW alone on the same inputs and compression alone on the same
gradients are in ``test_torch_substrate.py`` and
``test_torch_compression.py``).

Bounds, per leaf, relative to the leaf's largest reference value: 1e-4
for gradients, ``mu`` and ``nu`` (float32 sums in other orders), 2e-4 on
``efb`` (the DWT's cross-backend bound).  The loss, CE and gradient norm
within ``rtol=1e-5``; the learning rate equal.  Parameters are held in
units of the peak learning rate: the first Adam step is nearly
``lr * sign(g)``, so a gradient component at round-off level whose sign
flips between the packages moves a parameter by up to 2 lr; the bound is
1 lr over the three steps.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ShapeConfig as RShape
from repro.configs.qwen2_0_5b import FULL as R_QWEN, RUN as R_RUN
from repro.data import pipeline as RP
from repro.runtime import steps as RS

from repro_torch import convert, pytree
from repro_torch.configs.base import RunConfig
from repro_torch.configs.qwen2_0_5b import FULL as P_QWEN
from repro_torch.runtime import steps as PS

NARROW = dict(n_layers=2, d_model=112, d_ff=192, vocab_size=1000,
              dtype="float32")
SHAPE = (32, 4)             # seq, global batch
LEAF_RTOL = 1e-4
PARAM_LR_UNITS = 1.0


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


def assert_leaves_close(ref_tree, got_tree, rtol=LEAF_RTOL):
    """Per leaf: max |got - ref| <= rtol * max |ref|."""
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

def _configs(grad_accum=1, compression="none"):
    rc = dataclasses.replace(R_QWEN, **NARROW)
    pc = dataclasses.replace(P_QWEN, **NARROW)
    rrun = dataclasses.replace(R_RUN, grad_accum=grad_accum,
                               grad_compression=compression, warmup_steps=2)
    return rc, pc, rrun, RunConfig(**dataclasses.asdict(rrun))


def _batch(cfg, step):
    return RP.make_pipeline(cfg, seed=0).batch_at(
        step, RShape("s", "train", *SHAPE))


def test_loss_and_grads_match_reference():
    rc, pc, rrun, prun = _configs()
    state = RS.init_train_state(jax.random.PRNGKey(0), rc, rrun)
    batch = _batch(rc, 0)
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(RS.lm_loss, has_aux=True),
        static_argnames=("cfg", "run"))(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=rc,
        run=rrun)
    model = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, state.params), pc, device="cpu")
    pgrads, pmetrics = PS.grads_and_metrics(
        model.tree(), {k: torch.from_numpy(v) for k, v in batch.items()},
        pc, prun)
    np.testing.assert_allclose(float(pmetrics["loss"]), float(loss),
                               rtol=1e-5)
    assert_leaves_close(grads, pgrads)
    assert all(p.grad is None for p in model.parameters())


TRAJECTORIES = [(1, "none"), (2, "none"), (2, "dwt:2")]


@pytest.fixture(scope="module", params=TRAJECTORIES,
                ids=lambda p: f"accum{p[0]}-{p[1]}")
def trajectory(request):
    """Three train steps of both packages from the reference's state (the
    reference's step jitted once per configuration)."""
    rc, pc, rrun, prun = _configs(*request.param)
    state = RS.init_train_state(jax.random.PRNGKey(0), rc, rrun)
    pstate = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), pc, device="cpu")
    step = jax.jit(RS.train_step, static_argnames=("cfg", "run"))
    metrics = []
    for i in range(3):
        batch = _batch(rc, i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        cfg=rc, run=rrun)
        pstate, pm = PS.train_step(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
            prun)
        metrics.append((m, pm))
    return rrun, state, pstate, metrics


def test_train_step_metrics_match(trajectory):
    _, _, pstate, metrics = trajectory
    for m, pm in metrics:
        assert sorted(pm) == sorted(m)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-5)
        assert float(pm["lr"]) == float(m["lr"])
    assert int(pstate.step) == 3 and int(pstate.opt.count) == 3


def test_train_state_after_three_steps(trajectory):
    rrun, state, pstate, _ = trajectory
    assert_leaves_close(state.opt.mu, pstate.opt.mu)
    assert_leaves_close(state.opt.nu, pstate.opt.nu)
    if rrun.grad_compression == "none":
        assert state.efb == {} and pstate.efb == {}
    else:
        assert_leaves_close(state.efb, pstate.efb, rtol=2e-4)
    lr_peak = rrun.lr
    for want, got in zip(jax.tree_util.tree_leaves(state.params),
                         pytree.leaves(pstate.params)):
        diff = float(np.abs(np.asarray(want) - _np(got)).max())
        assert diff <= PARAM_LR_UNITS * lr_peak, diff / lr_peak


