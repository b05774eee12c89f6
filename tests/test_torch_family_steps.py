"""Gradients and a compressed train step of the port's MoE, RWKV6,
Mamba2-hybrid and Whisper families (``repro_torch.runtime.steps``)
against the reference's, on its SMOKE configs at float32.

The helpers (configs, port-made parameters carried to the reference,
batches, bounds) are ``test_torch_models.py``'s.  Each reference function
runs jitted except the compression inside the reference's step: jitted,
the compression's programs take 15-40 s per arch to compile, where
unjitted each op compiles once per tile shape and the families share most
tile shapes.  The step compresses at one level (``dwt:1``): two levels
double what the reference compiles, and the port's two-level compression
is held against the reference's on its own in
``test_torch_compression.py`` and composed in a train step in
``test_torch_train_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.runtime import steps as RS

from repro_torch import pytree
from repro_torch.runtime import steps as PS

from test_torch_models import (ARCHS, _batch, _configs, _j, _np, _params,
                               _t, _to_jax, assert_leaves_close)

RUN = dict(grad_compression="dwt:1", warmup_steps=2)

# the reference train step's gradient function (jax.value_and_grad of its
# lm_loss at grad_accum 1) and its optimizer, each compiled once per arch
R_GRADS = jax.jit(RS._grads, static_argnames=("cfg", "run"))
R_ADAMW = jax.jit(RA.apply, static_argnames=("run", "clip_norm"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax_grad(arch):
    """``lm_loss`` (chunked CE + 0.01 aux) and ``grads_and_metrics``
    against the reference's ``jax.value_and_grad`` of its ``lm_loss``
    (``steps._grads``), leaf by leaf: the MoE aux loss's gradient (the
    router's) included."""
    rc, pc, rrun, prun = _configs(arch, run=RUN)
    params, model = _params(arch, rc, pc)
    batch = _batch(rc)
    ref_g, ref_m = R_GRADS(params, _j(batch), cfg=rc, run=rrun)
    with torch.no_grad():
        _, m0 = PS.lm_loss(model.tree(), _t(batch), pc, prun)
    grads, m = PS.grads_and_metrics(model.tree(), _t(batch), pc, prun)
    for k in ("loss", "ce", "aux"):
        for got in (m0, m):
            np.testing.assert_allclose(float(got[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7)
    assert_leaves_close(ref_g, grads)
    assert (float(ref_m["aux"]) > 0) == (pc.family == "moe")
    if pc.family == "moe":
        assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0


def _reference_state(pstate):
    """The reference's ``TrainState`` holding the port's values."""
    return RS.TrainState(
        params=_to_jax(pstate.params),
        opt=RA.AdamWState(count=jnp.asarray(0, jnp.int32),
                          mu=_to_jax(pstate.opt.mu),
                          nu=_to_jax(pstate.opt.nu)),
        efb=_to_jax(pstate.efb), step=jnp.asarray(0, jnp.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_train_step_matches_reference(arch, monkeypatch):
    """One compressed train step from the same state in both packages:
    the metrics (the MoE aux loss included), ``mu``, ``nu``, the error
    feedback and the parameters, bounded as
    ``tests/test_torch_train_step.py``'s trajectories (1e-4 per leaf,
    2e-4 on the error feedback, parameters within one learning rate).
    The reference's ``train_step`` runs with its gradient function and
    AdamW jitted: the gradients are the same compiled program as the test
    above's, so no arch compiles them twice."""
    rc, pc, rrun, prun = _configs(arch, run=RUN)
    pstate = PS.init_train_state(torch.Generator().manual_seed(3), pc, prun,
                                 device="cpu")
    batch = _batch(rc)
    monkeypatch.setattr(RS, "_grads", lambda p, b, cfg, run: R_GRADS(
        p, b, cfg=cfg, run=run))
    monkeypatch.setattr(RA, "apply", lambda g, s, p, run: R_ADAMW(
        g, s, p, run=run))
    state, m = RS.train_step(_reference_state(pstate), _j(batch), rc, rrun)
    pstate, pm = PS.train_step(pstate, _t(batch), pc, prun)
    assert sorted(pm) == sorted(m)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-5,
                                   atol=1e-7)
    assert float(pm["lr"]) == float(m["lr"]) and int(pstate.step) == 1
    assert_leaves_close(state.opt.mu, pstate.opt.mu)
    assert_leaves_close(state.opt.nu, pstate.opt.nu)
    assert_leaves_close(state.efb, pstate.efb, rtol=2e-4)
    for want, got in zip(jax.tree_util.tree_leaves(state.params),
                         pytree.leaves(pstate.params)):
        diff = float(np.abs(np.asarray(want) - _np(got)).max())
        assert diff <= rrun.lr, diff / rrun.lr


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_gradients_at_grad_accum_2_match_reference(arch):
    """Two microbatches (``grad_accum=2``, as the card's phases 3g-3i
    run): the port's summed gradients and the last microbatch's metrics
    against the reference's scan over microbatches, leaf by leaf."""
    rc, pc, rrun, prun = _configs(arch, run=RUN)
    rrun = dataclasses.replace(rrun, grad_accum=2)
    prun = dataclasses.replace(prun, grad_accum=2)
    params, model = _params(arch, rc, pc)
    batch = _batch(rc)
    ref_g, ref_m = R_GRADS(params, _j(batch), cfg=rc, run=rrun)
    grads, m = PS.grads_and_metrics(model.tree(), _t(batch), pc, prun)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5,
                                   atol=1e-7)
    assert_leaves_close(ref_g, grads)
