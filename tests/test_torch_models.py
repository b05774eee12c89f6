"""The port's MoE, RWKV6, Mamba2-hybrid and Whisper families
(``repro_torch.models.moe``, ``rwkv``, ``ssm``, ``lm``) against the
reference's, on its SMOKE configs.

Parameters are made by the port (``torch.Generator``) and carried to
the reference as arrays (its ``jax.random`` init compiles op by op and
would cost more than the comparisons); batches come from the reference's
pipeline (seed 0), and every reference function runs jitted, compiled once
per configuration.  Bounds: at ``dtype="float32"`` forward
logits, the loss, prefill and decode within ``rtol=1e-4, atol=1e-5``
(same arithmetic, other reduction orders); gradients per leaf within 1e-4
of the leaf's largest reference value.  At bfloat16 the port's
log-softmax is no further from the reference's float32 result than 1.25x
the reference's own bfloat16 result is (``tests/test_torch_lm.py`` says
why); prefill/decode against the port's own forward within the
reference's bounds, 2e-2 for moe/encdec and 8e-2 for ssm/hybrid
(``tests/test_models.py:43``).  The MoE consistency checks use
``capacity_factor=8.0``, as the reference's do, so that no token is
dropped.  The reference's results are computed once per arch and dtype.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as RR
from repro.configs.base import ShapeConfig as RShape
from repro.data import pipeline as RP
from repro.models import common as RCm
from repro.models import lm as RL
from repro.models import moe as RM
from repro.models import rwkv as RW
from repro.models import ssm as RSS

from repro_torch import pytree
from repro_torch.configs import registry as PR
from repro_torch.configs.base import RunConfig
from repro_torch.models import common as PCm
from repro_torch.models import lm as PL
from repro_torch.models import moe as PM
from repro_torch.models import rwkv as PW
from repro_torch.models import ssm as PSS
from repro_torch.runtime import steps as PS

ARCHS = ("mixtral-8x7b", "dbrx-132b", "rwkv6-3b", "zamba2-2.7b",
         "whisper-medium")
FP32_TOL = dict(rtol=1e-4, atol=1e-5)
# zamba2's SSD sums log-decays over a 64-token chunk to |cum| ~ 100, where
# a float32 ulp is 7.6e-6; XLA's cumsum rounds in another order than
# torch's (2 ulps apart on such data), so exp(cum_t - cum_s) and the
# logits after it differ by ~1.5e-5 in both directions
SSD_TOL = dict(rtol=1e-4, atol=3e-5)
LEAF_RTOL = 1e-4
BF16_VS_REFERENCE = 1.25
DECODE_TOL = {"moe": 2e-2, "encdec": 2e-2, "ssm": 8e-2, "hybrid": 8e-2}
SHAPE = (32, 4)             # seq, global batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype="float32", run=None, **changes):
    """(reference cfg, port cfg, reference run, port run) of a SMOKE, the
    run in one microbatch and changed by ``run``."""
    rc, rrun = RR.get_config(arch, smoke=True)
    pc, _ = PR.get_config(arch, smoke=True)
    changes["dtype"] = dtype
    rrun = dataclasses.replace(rrun, grad_accum=1, **(run or {}))
    return (dataclasses.replace(rc, **changes),
            dataclasses.replace(pc, **changes), rrun,
            RunConfig(**dataclasses.asdict(rrun)))


_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _to_jax(tree):
    return jax.tree_util.tree_map(
        jnp.asarray, pytree.tree_map(lambda t: t.detach().numpy(), tree))


def _params(arch, rc, pc):
    """The reference's parameter tree and the port's LM holding the same
    values (made once per arch; the compute dtype and the capacity factor
    do not change them)."""
    model = _memo(("params", arch), lambda: PL.LM(
        pc, generator=torch.Generator().manual_seed(3), device="cpu"))
    return _memo(("jax", arch), lambda: _to_jax(model.tree())), \
        PL.LM(pc, params=model.tree())


# the reference's entry points, each compiled once per configuration
R_FORWARD = jax.jit(RL.forward, static_argnames=("cfg",))
R_WHISPER = jax.jit(RL.whisper_forward, static_argnames=("cfg",))
R_PREFILL = jax.jit(RL.prefill, static_argnames=("cfg", "max_len"))
R_DECODE = jax.jit(RL.decode_step, static_argnames=("cfg",))
R_WPREFILL = jax.jit(RL.whisper_prefill, static_argnames=("cfg", "batch"))
R_WDECODE = jax.jit(RL.whisper_decode_step, static_argnames=("cfg",))


def _batch(rc, step=0):
    return RP.make_pipeline(rc, seed=0).batch_at(step, RShape("s", "train",
                                                              *SHAPE))


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tol(cfg):
    return SSD_TOL if cfg.family == "hybrid" else FP32_TOL


def _ref_forward(params, rc, batch):
    b = _j(batch)
    if rc.family == "encdec":
        return R_WHISPER(params, b["enc_embeds"], b["dec_tokens"], cfg=rc)
    return R_FORWARD(params, b["tokens"], cfg=rc)


@torch.no_grad()
def _port_forward(model, batch):
    b = _t(batch)
    if model.cfg.family == "encdec":
        return model.whisper_forward(b["enc_embeds"], b["dec_tokens"])
    return model.forward(b["tokens"])


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _lsm(x):
    return torch.log_softmax(torch.as_tensor(_np(x)), -1)


def assert_leaves_close(ref_tree, got_tree, rtol=LEAF_RTOL):
    """Per leaf, in the reference's leaf order: max |got - ref| <= rtol *
    max |ref|."""
    ref = jax.tree_util.tree_leaves(ref_tree)
    got = pytree.leaves(got_tree)
    assert len(ref) == len(got)
    for want, have in zip(ref, got):
        want = np.asarray(want, np.float64)
        have = _np(have).astype(np.float64)
        assert want.shape == have.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(want - have).max()) <= rtol * scale


# ---------------------------------------------------------------------------
# Forward, loss and gradients of each family
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32(arch):
    """Logits and the aux loss of the forward (``whisper_forward`` for
    encdec) on step 0's batch."""
    rc, pc, _, _ = _configs(arch)
    params, model = _params(arch, rc, pc)
    batch = _batch(rc)
    want, want_aux = _ref_forward(params, rc, batch)
    got, aux = _port_forward(model, batch)
    v = pc.vocab_size
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got)[..., :v], np.asarray(want)[..., :v],
                               **_tol(pc))
    assert bool((got[..., v:] == torch.finfo(torch.float32).min).all())
    np.testing.assert_allclose(float(aux), float(want_aux), **FP32_TOL)
    assert (float(aux) > 0) == (pc.family == "moe")


def _flips(err, median_factor=4.0):
    """Positions whose log-softmax error is over ``median_factor`` x the
    median position's: MoE tokens whose top-k routing flipped."""
    per_pos = err.amax(-1)
    return per_pos > median_factor * per_pos.median()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bfloat16_log_softmax(arch):
    """The port's bfloat16 forward is no further from the reference's
    float32 forward than the reference's bfloat16 forward is (x1.25).

    MoE routing is discontinuous: a token whose top-k experts nearly tie
    in float32 can take another expert in bfloat16, in either package,
    and its logits jump (one of mixtral's 128 tokens here, in the
    reference too: 0.31 against a median of 0.026).  For the MoE archs
    the bound holds on the tokens neither package flipped, and the port
    flips no more tokens than the reference does."""
    rc32, _, _, _ = _configs(arch)
    rc, pc, _, _ = _configs(arch, "bfloat16")
    params, model = _params(arch, rc, pc)
    batch = _batch(rc, step=1)
    v = pc.vocab_size
    truth = _lsm(_ref_forward(params, rc32, batch)[0][..., :v])
    ref_err = (_lsm(_ref_forward(params, rc, batch)[0][..., :v])
               - truth).abs()
    got, _ = _port_forward(model, batch)
    assert got.dtype == torch.bfloat16
    err = (_lsm(got[..., :v]) - truth).abs()
    if pc.family == "moe":
        ref_flips, flips = _flips(ref_err), _flips(err)
        assert int(flips.sum()) <= int(ref_flips.sum())
        keep = ~(ref_flips | flips)
        ref_err, err = ref_err[keep], err[keep]
    assert float(err.max()) <= BF16_VS_REFERENCE * float(ref_err.max()), \
        (float(err.max()), float(ref_err.max()))


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

def _decode_configs(arch, dtype):
    """No MoE drops in the consistency checks (tests/test_models.py:23)."""
    extra = {"capacity_factor": 8.0} if RR.get_config(
        arch, smoke=True)[0].is_moe else {}
    return _configs(arch, dtype, **extra)


def _assert_caches_close(r_cache, cache, tol=FP32_TOL):
    """Every leaf by path (the reference's dict order)."""
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(r_cache)[0]]
    assert paths == [pytree.keystr(p) for p, _ in
                     pytree.leaves_with_path(cache)]
    for want, got in zip(jax.tree_util.tree_leaves(r_cache),
                         pytree.leaves(cache)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper-medium"])
def test_prefill_decode_match_reference_and_forward(arch, dtype):
    """Prefill of 16 tokens and one decode step: the logits and every
    cache leaf against the reference's (float32), and the logits against
    the port's own forward (tests/test_models.py:21)."""
    rc, pc, _, _ = _decode_configs(arch, dtype)
    params, model = _params(arch, rc, pc)
    toks = _batch(rc, step=3)["tokens"][:2, :17]
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = model.forward(tt)
        lg0, cache = model.prefill(tt[:, :16], 32)
        lg, cache2 = model.decode_step(cache, tt[:, 16:17])
    assert int(cache["pos"]) == 16 and int(cache2["pos"]) == 17
    v = pc.vocab_size
    if dtype == "float32":
        r_lg0, r_cache = R_PREFILL(params, jt[:, :16], cfg=rc, max_len=32)
        r_lg, r_cache2 = R_DECODE(params, r_cache, jt[:, 16:17], cfg=rc)
        tol = _tol(pc)
        np.testing.assert_allclose(_np(lg0)[:, :v], np.asarray(r_lg0)[:, :v],
                                   **tol)
        np.testing.assert_allclose(_np(lg)[:, :v], np.asarray(r_lg)[:, :v],
                                   **tol)
        _assert_caches_close(r_cache, cache, tol)
        _assert_caches_close(r_cache2, cache2, tol)
    for got, want in ((lg0, full[:, 15]), (lg, full[:, 16])):
        err = float((_lsm(got[:, :v]) - _lsm(want[:, :v])).abs().max())
        assert err < DECODE_TOL[pc.family], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_prefill_and_decode(dtype):
    """``whisper_prefill`` then 4 decode steps: logits and caches against
    the reference's (float32), and step 4 against ``whisper_forward`` at
    position 3; ``prefill_step`` returns zero logits and the same cache."""
    rc, pc, _, _ = _configs("whisper-medium", dtype)
    params, model = _params("whisper-medium", rc, pc)
    batch = _batch(rc, step=3)
    enc, dec = batch["enc_embeds"][:2], batch["dec_tokens"][:2]
    with torch.no_grad():
        full, _ = model.whisper_forward(torch.from_numpy(enc),
                                        torch.from_numpy(dec))
        cache = model.whisper_prefill(torch.from_numpy(enc))
        zeros, again = PS.prefill_step(model.tree(), {
            "enc_embeds": torch.from_numpy(enc)}, pc, 32)
    assert float(zeros.abs().max()) == 0.0 and zeros.dtype == torch.float32
    for a, b in zip(pytree.leaves(cache), pytree.leaves(again)):
        assert torch.equal(a, b)
    if dtype == "float32":
        r_cache = R_WPREFILL(params, jnp.asarray(enc), cfg=rc, batch=2)
        _assert_caches_close(r_cache, cache)
    v = pc.vocab_size
    for t in range(4):
        tok = dec[:, t:t + 1]
        with torch.no_grad():
            lg, cache = PS.decode_step(model.tree(), cache,
                                       torch.from_numpy(tok), pc)
        if dtype == "float32":
            r_lg, r_cache = R_WDECODE(params, r_cache, jnp.asarray(tok),
                                      cfg=rc)
            np.testing.assert_allclose(_np(lg)[:, :v],
                                       np.asarray(r_lg)[:, :v], **FP32_TOL)
    assert int(cache["pos"]) == 4
    if dtype == "float32":
        _assert_caches_close(r_cache, cache)
    err = float((_lsm(lg[:, :v]) - _lsm(full[:, 3, :v])).abs().max())
    assert err < DECODE_TOL["encdec"], err


def test_whisper_decode_position_clamps():
    """Past ``max_target_len`` the decoder's position embedding stays at
    the last row, as the reference's ``dynamic_slice`` clamps it."""
    rc, pc, _, _ = _configs("whisper-medium")
    params, model = _params("whisper-medium", rc, pc)
    enc = _batch(rc)["enc_embeds"][:2]
    r_cache = R_WPREFILL(params, jnp.asarray(enc), cfg=rc, batch=2)
    with torch.no_grad():
        cache = model.whisper_prefill(torch.from_numpy(enc))
    at = rc.max_target_len + 2
    r_cache = dict(r_cache, pos=jnp.asarray(at, jnp.int32))
    cache = dict(cache, pos=torch.tensor(at, dtype=torch.int32))
    tok = np.array([[5], [7]], np.int32)
    r_lg, _ = R_WDECODE(params, r_cache, jnp.asarray(tok), cfg=rc)
    with torch.no_grad():
        lg, _ = model.whisper_decode_step(cache, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(lg), np.asarray(r_lg), **FP32_TOL)


def test_sliding_window_ring_buffer_rollover_on_mixtral():
    """Decode past the sliding window from scratch (20 steps over a window
    of 8, tests/test_lm_decode.py:16): the port equals the reference step
    by step, and its last logits equal its own full forward."""
    rc, pc, _, _ = _configs("mixtral-8x7b", capacity_factor=8.0,
                            sliding_window=8)
    params, model = _params("mixtral-8x7b", rc, pc)
    toks = np.random.default_rng(4).integers(0, rc.vocab_size,
                                             (2, 21)).astype(np.int32)
    r_cache = RL.init_decode_cache(rc, 2, 32)
    with torch.no_grad():
        cache = model.init_decode_cache(2, 32)
        assert cache["kv"]["k"].shape[2] == 8
        for t in range(20):
            r_lg, r_cache = R_DECODE(params, r_cache,
                                     jnp.asarray(toks[:, t:t + 1]), cfg=rc)
            lg, cache = model.decode_step(cache,
                                          torch.from_numpy(toks[:, t:t + 1]))
            np.testing.assert_allclose(_np(lg), np.asarray(r_lg), **FP32_TOL)
        full, _ = model.forward(torch.from_numpy(toks[:, :20]))
    _assert_caches_close(r_cache, cache)
    err = float((_lsm(lg) - _lsm(full[:, 19])).abs().max())
    assert err < 2e-2, err


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------

def _layer(init, pc, seed):
    """One layer's parameters from the port's ``init`` (the stacked axis
    dropped), and the same values as the reference's arrays."""
    p = pytree.tree_map(lambda t: t[0].clone(),
                        init(torch.Generator().manual_seed(seed), pc, 1,
                             "cpu"))
    return p, _to_jax(p)


def _moe_case(arch, seed, shape, offset=0.0, **changes):
    rc, pc, _, _ = _configs(arch, **changes)
    p, params = _layer(PM.init_moe, pc, seed)
    x = (np.random.default_rng(seed).standard_normal(
        shape + (rc.d_model,)) * 0.3 + offset).astype(np.float32)
    return rc, pc, params, x, p


@pytest.mark.parametrize("case", ["drops", "chunked", "full_capacity"])
def test_moe_ffn_matches_reference(monkeypatch, case):
    """``moe_ffn`` against the reference's: at capacity 1.25 with tokens
    dropped (a shared offset in the input crowds one expert), over
    ``SEQ_CHUNK``-long chunks (patched to 8 in both packages: capacity per
    chunk, each chunk recomputed in the backward pass) and at full
    capacity (decode); outputs, aux loss and the gradients of the input
    and of every weight."""
    full = case == "full_capacity"
    rc, pc, params, x, p = _moe_case("mixtral-8x7b", 5, (2, 32),
                                     offset=0.5 if case == "drops" else 0.0)
    if case == "chunked":
        monkeypatch.setattr(RM, "SEQ_CHUNK", 8)
        monkeypatch.setattr(PM, "SEQ_CHUNK", 8)
    w = np.cos(np.arange(x.size)).reshape(x.shape).astype(np.float32)

    def ref_loss(params, x):
        y, aux = RM.moe_ffn(params, x, rc, full_capacity=full)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y_ref, aux_ref)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = PM.moe_ffn(p, xt, pc, full_capacity=full)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **FP32_TOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-5)
    assert_leaves_close({"x": g_x, **g_p}, {"x": xt.grad, **{
        k: v.grad for k, v in p.items()}})
    t = x.shape[0] * (8 if case == "chunked" else x.shape[1])
    cap = t if full else RM._capacity(t, rc)
    assert PM._capacity(t, pc) == RM._capacity(t, rc)
    if case == "drops":   # some (token, k) overflowed and fell through
        with torch.no_grad():
            logits = torch.from_numpy(x).reshape(-1, rc.d_model) \
                @ p["router"]
            idx = torch.topk(torch.softmax(logits, -1), rc.top_k).indices
        assert int(torch.bincount(idx.reshape(-1)).max()) > cap


def test_moe_matches_dense_reference():
    """With ample capacity, dispatch equals running every expert on every
    token and combining by the top-k gates (tests/test_substrate.py:107)."""
    _, pc, _, x, p = _moe_case("mixtral-8x7b", 1, (2, 8),
                               capacity_factor=16.0)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, aux = PM.moe_ffn(p, xt, pc)
        flat = xt.reshape(-1, pc.d_model)
        probs = torch.softmax(flat @ p["router"], -1)
        gv, gi = torch.topk(probs, pc.top_k)
        gv = gv / gv.sum(-1, keepdim=True)
        outs = torch.stack([
            (PCm.silu(flat @ p["gate"][e]) * (flat @ p["up"][e]))
            @ p["down"][e] for e in range(pc.n_experts)], 1)
        ref = sum(gv[:, k:k + 1] * outs[torch.arange(flat.shape[0]),
                                        gi[:, k]]
                  for k in range(pc.top_k))
    np.testing.assert_allclose(_np(y.reshape(-1, pc.d_model)), _np(ref),
                               rtol=2e-2, atol=2e-3)
    assert float(aux) > 0


def test_moe_full_capacity_no_drops():
    """Full capacity equals a capacity factor too large to drop anything
    (tests/test_substrate.py:138)."""
    _, pc, _, x, p = _moe_case("dbrx-132b", 2, (4, 1))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y_full, _ = PM.moe_ffn(p, xt, pc, full_capacity=True)
        y_big, _ = PM.moe_ffn(p, xt, dataclasses.replace(
            pc, capacity_factor=64.0))
    np.testing.assert_allclose(_np(y_full), _np(y_big), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def test_rwkv_time_and_channel_mix_with_carried_state():
    """``time_mix`` and ``channel_mix`` from zero state and from a carried
    wkv state and shifts (a bonus and decays away from their flat init,
    so both terms count): outputs, states and shifts."""
    rc, pc, _, _ = _configs("rwkv6-3b")
    p, _ = _layer(PW.init_rwkv_block, pc, 6)
    rng = np.random.default_rng(6)
    p["bonus_u"] = torch.from_numpy(
        rng.standard_normal(p["bonus_u"].shape).astype(np.float32) * 0.5)
    p["decay_bias"] = torch.from_numpy(
        rng.uniform(-3, 0, p["decay_bias"].shape).astype(np.float32))
    params = _to_jax(p)
    x = (rng.standard_normal((2, 24, rc.d_model)) * 0.5).astype(np.float32)
    nh = RW.n_heads(rc)
    state = (rng.standard_normal((2, nh, 64, 64)) * 0.1).astype(np.float32)
    prev = (rng.standard_normal((2, rc.d_model)) * 0.5).astype(np.float32)
    ref = jax.jit(lambda params, x, st, pv: (
        RW.time_mix(params, x, rc, state=st, prev=pv),
        RW.channel_mix(params, x, rc, prev=pv)))
    for st, pv in ((None, None), (state, prev)):
        (ry, rs, rl), (rcy, rcl) = ref(
            params, jnp.asarray(x), *(None if a is None else jnp.asarray(a)
                                      for a in (st, pv)))
        tst, tpv = (None if a is None else torch.from_numpy(a)
                    for a in (st, pv))
        with torch.no_grad():
            y, s, last = PW.time_mix(p, torch.from_numpy(x), pc, state=tst,
                                     prev=tpv)
            cy, cl = PW.channel_mix(p, torch.from_numpy(x), pc, prev=tpv)
        for got, want in ((y, ry), (s, rs), (last, rl), (cy, rcy),
                          (cl, rcl)):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       **FP32_TOL)


def test_wkv_scan_over_64_tokens_in_checkpointed_chunks(monkeypatch):
    """``_wkv_scan`` over 64 tokens in chunks of 16 (each recomputed in the
    backward pass) against the reference's per-token scan: outputs, the
    final state and the gradients of r, k, v, the decay, u and the
    initial state."""
    monkeypatch.setattr(PW, "WKV_CHUNK", 16)
    rng = np.random.default_rng(7)
    b, s, nh, hd = 2, 64, 2, 64
    r, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) * 0.3
               for _ in range(3))
    log_w = -np.exp(rng.uniform(-4, 1, (b, s, nh, hd))).astype(np.float32)
    u = (rng.standard_normal((nh, hd)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, nh, hd, hd)) * 0.1).astype(np.float32)
    inputs = (r, k, v, log_w, u, s0)
    wy = np.cos(np.arange(b * s * nh * hd)).reshape(b, s, nh, hd)
    ws = np.sin(np.arange(b * nh * hd * hd)).reshape(b, nh, hd, hd)
    wy, ws = wy.astype(np.float32), ws.astype(np.float32)

    def ref_loss(*a):
        y, st = RW._wkv_scan(*a)
        return jnp.sum(y * wy) + jnp.sum(st * ws), (y, st)

    (_, (ry, rs)), rg = jax.jit(jax.value_and_grad(
        ref_loss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, inputs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y, st = PW._wkv_scan(*ts)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(st * torch.from_numpy(ws))).backward()
    np.testing.assert_allclose(_np(y), np.asarray(ry), **FP32_TOL)
    np.testing.assert_allclose(_np(st), np.asarray(rs), **FP32_TOL)
    assert_leaves_close(list(rg), [t.grad for t in ts])


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _mamba_case(seed, s):
    rc, pc, _, _ = _configs("zamba2-2.7b")
    p, params = _layer(PSS.init_mamba, pc, seed)
    x = (np.random.default_rng(seed).standard_normal(
        (2, s, rc.d_model)) * 0.5).astype(np.float32)
    return rc, pc, params, p, x


def _mamba_grads(rc, params, p, x, pc):
    """The reference's and the port's loss, output, state and gradients
    (of x and every weight) for ``sum(y * w) + sum(final state)``."""
    w = np.cos(np.arange(x.size)).reshape(x.shape).astype(np.float32)

    def ref_loss(params, x):
        y, st = RSS.mamba_forward(params, x, rc, return_state=True)
        return jnp.sum(y * w) + jnp.sum(st["ssm"]), (y, st)

    (r_loss, (ry, rst)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, st = PSS.mamba_forward(p, xt, pc, return_state=True)
    loss = torch.sum(y * torch.from_numpy(w)) + torch.sum(st["ssm"])
    loss.backward()
    grads = {"x": xt.grad, **{k: v.grad for k, v in p.items()}}
    return (r_loss, ry, rst, {"x": g_x, **g_p}), (loss, y, st, grads)


def test_mamba_forward_over_three_chunks_with_state():
    """``mamba_forward`` over 3 chunks of ``CHUNK`` tokens (the carried
    inter-chunk state at work) with ``return_state``: output, final SSM
    state and conv history, and the gradients of x and every weight."""
    assert PSS.CHUNK == RSS.CHUNK
    rc, pc, params, p, x = _mamba_case(8, 3 * RSS.CHUNK)
    (_, ry, rst, r_g), (_, y, st, g) = _mamba_grads(rc, params, p, x, pc)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **FP32_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(st[k]), np.asarray(rst[k]),
                                   **FP32_TOL)
    assert_leaves_close(r_g, g)


def test_mamba_decode_chain_equals_forward():
    """Prefill 8 tokens with ``return_state`` then decode the next 8 one at
    a time: each step equals the full forward at that position, and the
    reference's decode step."""
    rc, pc, params, p, x = _mamba_case(9, 16)
    with torch.no_grad():
        full = PSS.mamba_forward(p, torch.from_numpy(x), pc)
        _, cache = PSS.mamba_forward(p, torch.from_numpy(x[:, :8]), pc,
                                     return_state=True)
    _, r_cache = jax.jit(lambda params, x: RSS.mamba_forward(
        params, x, rc, return_state=True))(params, jnp.asarray(x[:, :8]))
    r_step = jax.jit(lambda params, c, x: RSS.mamba_decode_step(
        params, c, x, rc))
    for t in range(8, 16):
        with torch.no_grad():
            y, cache = PSS.mamba_decode_step(p, cache,
                                             torch.from_numpy(x[:, t:t + 1]),
                                             pc)
        r_y, r_cache = r_step(params, r_cache, jnp.asarray(x[:, t:t + 1]))
        np.testing.assert_allclose(_np(y), np.asarray(r_y), **FP32_TOL)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, t]),
                                   rtol=1e-4, atol=1e-4)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(cache[k]), np.asarray(r_cache[k]),
                                   **FP32_TOL)


def test_mamba_large_dt_gradient_stays_finite():
    """A large dt overflows the reference's unmasked decay above the
    diagonal (exp of a large positive number), and its backward pass
    multiplies the masked zero by inf; the port masks before the exp.
    The loss and outputs agree; where the reference's gradient is finite
    the port's equals it, and the port's is finite everywhere."""
    rc, pc, _, p, x = _mamba_case(10, RSS.CHUNK)
    p["dt_bias"] = torch.full_like(p["dt_bias"], 30.0)
    (r_loss, ry, _, r_g), (loss, y, _, g) = _mamba_grads(
        rc, _to_jax(p), p, x, pc)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **FP32_TOL)
    assert not np.isfinite(np.asarray(r_g["x"])).all()   # the overflow
    for name, want in r_g.items():
        want, have = np.asarray(want), _np(g[name])
        assert np.isfinite(have).all(), name
        ok = np.isfinite(want)
        scale = max(float(np.abs(want[ok]).max(initial=0.0)), 1e-30)
        assert float(np.abs(have[ok] - want[ok]).max(initial=0.0)) \
            <= LEAF_RTOL * scale, name


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,d", [(32, 64), (448, 1024), (7, 6)])
def test_sinusoid_positions(length, d):
    """The table against the reference's: equal to a few float32 ulps of
    the largest angle (``length`` radians), where the two packages' exp of
    the frequencies may differ by one ulp."""
    got = PCm.sinusoid_positions(length, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, d)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RCm.sinusoid_positions(length, d)), rtol=0,
        atol=4 * length * np.finfo(np.float32).eps)
