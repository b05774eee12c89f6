"""The port's configs and dense/VLM language models
(``repro_torch.configs``, ``repro_torch.models``) against the
reference's.

Parameters are made by the reference (``jax.random``) and carried across
with ``repro_torch.convert.lm_params_from_numpy``; tokens come from a
numpy seed.  Bounds: at ``dtype="float32"`` forward logits, the chunked
CE, prefill and decode within ``rtol=1e-4, atol=1e-5`` (same arithmetic,
other reduction orders).  At bfloat16 the two packages round at other
places: the reference's scanned blocks are compiled by XLA, which keeps
some intermediates in float32 (its compiled attention chunk differs from
the same ops run one by one in a third of the outputs), so the
log-softmax of the two packages differs by 0.028-0.047 on these configs,
as much as bfloat16 moves the reference itself from its float32 result
(0.028-0.052).  At bfloat16 the port is held to that: its log-softmax is
no further from the reference's float32 result than 1.25x the
reference's own bfloat16 result is; and prefill/decode against the
port's own forward within 2e-2, the reference's own bound
(``tests/test_models.py:43``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as RR
from repro.configs.qwen2_0_5b import FULL as R_QWEN
from repro.models import lm as RL
from repro.runtime import steps as RS

from repro_torch import convert, pytree
from repro_torch.configs import registry as PR
from repro_torch.models import common as PCm
from repro_torch.models import lm as PL
from repro_torch.runtime import steps as PS

FP32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOGSOFTMAX = 2e-2      # prefill/decode vs forward, one package
BF16_VS_REFERENCE = 1.25    # x the reference's own bf16-vs-fp32 error
NARROW = dict(n_layers=2, d_model=112, d_ff=192, vocab_size=1000)
MODELS = ("qwen2-narrow", "phi4-mini-3.8b", "granite-34b", "pixtral-12b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, dtype=None):
    """(reference cfg, port cfg): qwen2 FULL narrowed (keeps the 14->16
    head padding, QKV bias, tying, rope_theta, norm_eps) or a SMOKE."""
    if name == "qwen2-narrow":
        from repro_torch.configs.qwen2_0_5b import FULL as P_QWEN
        rc = dataclasses.replace(R_QWEN, **NARROW)
        pc = dataclasses.replace(P_QWEN, **NARROW)
    else:
        rc, pc = RR.get_config(name, smoke=True)[0], \
            PR.get_config(name, smoke=True)[0]
    if dtype:
        rc = dataclasses.replace(rc, dtype=dtype)
        pc = dataclasses.replace(pc, dtype=dtype)
    return rc, pc


_PARAMS = {}


def _params(name, rc, pc):
    """Reference parameters (made once per config) and the port's LM."""
    key = (name, rc.dtype)
    if key not in _PARAMS:
        params = RL.init_params(jax.random.PRNGKey(3), rc)
        _PARAMS[key] = params
    params = _PARAMS[key]
    return params, convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), pc, device="cpu")


def _inputs(rc, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rc.vocab_size, (b, s)).astype(np.int32)
    emb = None
    if rc.family == "vlm":
        emb = (rng.standard_normal((b, 4, rc.d_model)) * 0.02).astype(
            np.float32)
    return toks, emb


def _opt(a, fn):
    return None if a is None else fn(a)


def _lsm(x):
    return torch.log_softmax(torch.as_tensor(np.asarray(x, np.float32)), -1)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        rc, rrun = RR.get_config(arch, smoke=smoke)
        pc, prun = PR.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
        assert dataclasses.asdict(rrun) == dataclasses.asdict(prun)
        assert (rc.head_dim, rc.n_heads_padded, rc.is_moe) \
            == (pc.head_dim, pc.n_heads_padded, pc.is_moe)
        assert rc.n_params() == pc.n_params()
        assert rc.n_active_params() == pc.n_active_params()


def test_cells_and_applicability_equal_the_reference():
    ref = [(a, dataclasses.asdict(s), r) for a, s, r in RR.all_cells()]
    got = [(a, dataclasses.asdict(s), r) for a, s, r in PR.all_cells()]
    assert ref == got and len(got) == 40
    assert PR.ARCH_IDS == RR.ARCH_IDS


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layouts(rc, pc):
    """(path, shape) of every leaf: the reference's eval_shape and the
    port's meta-device init (shapes only), and both dtype lists."""
    ref = jax.eval_shape(lambda: RL.init_params(jax.random.PRNGKey(0), rc))
    ref_flat = [(jax.tree_util.keystr(p), tuple(a.shape))
                for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]]
    got = PL.init_params(None, pc, "meta")
    got_flat = [(pytree.keystr(p), tuple(a.shape))
                for p, a in pytree.leaves_with_path(got)]
    dtypes = ([str(a.dtype) for a in jax.tree_util.tree_leaves(ref)],
              [str(a.dtype).replace("torch.", "")
               for a in pytree.leaves(got)])
    return ref_flat, got_flat, dtypes


def test_full_qwen2_layout_is_the_reference_layout():
    """Stacked leaves at qwen2-0.5b's full width, by shape and by path
    (the port's meta-device init against the reference's eval_shape)."""
    from repro_torch.configs.qwen2_0_5b import FULL as P_QWEN
    ref_flat, got_flat, _ = _layouts(R_QWEN, P_QWEN)
    assert got_flat == ref_flat
    assert dict(got_flat)["['blocks']['attn']['wq']"] == (24, 896, 16, 64)
    assert dict(got_flat)["['embed']['tok']"] == (153600, 896)
    n = sum(int(np.prod(s)) for _, s in got_flat)
    assert 495e6 < n < 505e6


@pytest.mark.parametrize("arch", [a for a in RR.ARCH_IDS
                                  if a != "qwen2-0.5b"])
def test_full_layout_is_the_reference_layout(arch):
    """Every other arch's leaves at full width, by path, shape and dtype:
    the layout gradient compression tiles and checkpoints name (whisper's
    ``enc_blocks``/``dec_blocks``, zamba2's unstacked ``shared_attn``)."""
    ref_flat, got_flat, (ref_dt, got_dt) = _layouts(
        RR.get_config(arch)[0], PR.get_config(arch)[0])
    assert got_flat == ref_flat and got_dt == ref_dt
    if arch == "mixtral-8x7b":
        assert dict(got_flat)["['blocks']['moe']['gate']"] \
            == (32, 8, 4096, 14336)


def test_lm_module_registers_the_tree_and_zeroes_padded_heads():
    _, pc = _configs("qwen2-narrow")
    gen = torch.Generator().manual_seed(0)
    m = PL.LM(pc, generator=gen, device="cpu")
    names = dict(m.named_parameters())
    assert names["blocks.attn.wq"].shape == (2, 112, 16, 8)
    assert len(names) == 14
    assert names["blocks.attn.wq"] is m.tree()["blocks"]["attn"]["wq"]
    h = pc.n_heads
    assert float(names["blocks.attn.wq"][:, :, h:].abs().max()) == 0.0
    assert float(names["blocks.attn.wo"][:, h:].abs().max()) == 0.0
    assert float(names["blocks.attn.wq"][:, :, :h].abs().max()) > 0.0
    again = PL.LM(pc, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, every entry point that places tensors raises and
    names device="cpu" instead of carrying on on the CPU."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.runtime import train_loop as PT
    _, pc = _configs("qwen2-narrow")
    run = RunConfig(grad_compression="dwt:2")
    state = PS.init_train_state(torch.Generator().manual_seed(0), pc, run,
                                device="cpu")
    host = pytree.tree_map(lambda t: t.detach().numpy(), state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: PL.LM(pc, generator=torch.Generator()),
        lambda: PL.init_decode_cache(pc, 1, 8),
        lambda: PS.init_train_state(torch.Generator(), pc, run),
        lambda: convert.lm_params_from_numpy(host.params, pc),
        lambda: convert.train_state_from_numpy(host, pc),
        lambda: PT.train(pc, run, None, None, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match=r'device="cpu"'):
            call()


def test_an_unknown_family_raises_value_error():
    """Every family of the reference is ported; a family the reference
    does not know raises ValueError naming it, as the reference's
    ``lm.py`` does."""
    _, pc = _configs("qwen2-narrow")
    bad = dataclasses.replace(pc, family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        PL.LM(bad, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="retnet"):
        PL.init_decode_cache(bad, 1, 8, device="cpu")
    params = PL.LM(pc, generator=torch.Generator().manual_seed(0),
                   device="cpu").tree()
    with pytest.raises(ValueError, match="retnet"):
        PL.forward_hidden(params, torch.zeros((1, 4), dtype=torch.int32),
                          bad)


@pytest.mark.parametrize("arch", RR.ARCH_IDS)
def test_every_arch_trains_prefills_and_decodes(arch):
    """Every arch (SMOKE) builds an LM and runs forward, prefill and a
    decode step (whisper: its prefill and decode step) and a train step
    with ``grad_compression="dwt:2"`` and without, in the port alone:
    finite losses, the MoE aux loss above 0, every parameter moved."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    pc, prun = PR.get_config(arch, smoke=True)
    prun = dataclasses.replace(prun, grad_accum=2, grad_compression="dwt:2")
    state = PS.init_train_state(torch.Generator().manual_seed(0), pc, prun,
                                device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_pipeline(pc).batch_at(
        0, ShapeConfig("s", "train", 32, 4)).items()}
    before = pytree.leaves(state.params)
    for comp in ("dwt:2", "none"):
        run = dataclasses.replace(prun, grad_compression=comp)
        state, m = PS.train_step(state, batch, pc, run)
        assert bool(torch.isfinite(m["loss"]))
        assert (float(m["aux"]) > 0) == (pc.family == "moe")
    assert int(state.step) == 2
    assert all(bool((a != b).any())
               for a, b in zip(before, pytree.leaves(state.params)))
    vp = PCm.pad_vocab(pc.vocab_size)
    with torch.no_grad():
        if pc.family == "encdec":
            full, _ = PL.whisper_forward(state.params, batch["enc_embeds"],
                                         batch["dec_tokens"], pc)
            lg, cache = PS.prefill_step(state.params, batch, pc, 32)
            tok = batch["dec_tokens"][:, :1]
        else:
            full, _ = PL.forward(state.params, batch["tokens"], pc)
            lg, cache = PS.prefill_step(
                state.params, {"tokens": batch["tokens"][:, :16]}, pc, 32)
            tok = batch["tokens"][:, 16:17]
        lg, cache = PS.decode_step(state.params, cache, tok, pc)
    assert tuple(lg.shape) == (4, vp) and full.shape[-1] == vp
    assert bool(torch.isfinite(lg[:, :pc.vocab_size]).all())
    assert int(cache["pos"]) == (1 if pc.family == "encdec" else 17)


# ---------------------------------------------------------------------------
# Forward, chunked CE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_forward_and_ce_float32(name):
    rc, pc = _configs(name, "float32")
    params, model = _params(name, rc, pc)
    toks, emb = _inputs(rc)
    want, _ = RL.forward(params, jnp.asarray(toks), rc,
                         embeds=_opt(emb, jnp.asarray))
    with torch.no_grad():
        got, aux = model.forward(torch.from_numpy(toks),
                                 embeds=_opt(emb, torch.from_numpy))
    vp = PCm.pad_vocab(pc.vocab_size)
    assert tuple(got.shape) == (2, 24, vp) and float(aux) == 0.0
    v = pc.vocab_size
    np.testing.assert_allclose(got[..., :v].numpy(), np.asarray(want)[..., :v],
                               **FP32_TOL)
    assert bool((got[..., v:] == torch.finfo(torch.float32).min).all())
    # the loss: chunked CE on the same hidden states
    hidden, _ = RL.forward_hidden(params, jnp.asarray(toks), rc,
                                  embeds=_opt(emb, jnp.asarray))
    labels = np.roll(toks, -1, axis=1)
    mask = np.ones(toks.shape, np.float32)
    mask[:, -1] = 0
    ce_ref = RS.chunked_ce(params["embed"], hidden, jnp.asarray(labels),
                           jnp.asarray(mask), rc, chunk=8)
    with torch.no_grad():
        ce = PS.chunked_ce(model.tree()["embed"],
                           torch.from_numpy(np.asarray(hidden)),
                           torch.from_numpy(labels).long(),
                           torch.from_numpy(mask), pc, chunk=8)
    np.testing.assert_allclose(float(ce), float(ce_ref), **FP32_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_forward_bfloat16_log_softmax(name):
    """The port's bfloat16 forward is no further from the reference's
    float32 forward than the reference's bfloat16 forward is (x1.25)."""
    rc32, _ = _configs(name, "float32")
    rc, pc = _configs(name)
    assert pc.dtype == "bfloat16"
    params, model = _params(name, rc, pc)
    toks, emb = _inputs(rc, seed=1)
    v = pc.vocab_size

    def ref(cfg):
        out, _ = RL.forward(params, jnp.asarray(toks), cfg,
                            embeds=_opt(emb, jnp.asarray))
        return _lsm(np.asarray(out, np.float32)[..., :v])

    truth, ref_bf16 = ref(rc32), ref(rc)
    with torch.no_grad():
        got, _ = model.forward(torch.from_numpy(toks),
                               embeds=_opt(emb, torch.from_numpy))
    assert got.dtype == torch.bfloat16
    ref_err = float((ref_bf16 - truth).abs().max())
    err = float((_lsm(got.float()[..., :v]) - truth).abs().max())
    assert err <= BF16_VS_REFERENCE * ref_err, (err, ref_err)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_prefill_decode_match_reference_and_forward(name, dtype):
    """Prefill of 16 tokens and one decode step against the reference's
    (float32), and against the port's own full forward
    (tests/test_models.py:21)."""
    rc, pc = _configs(name, dtype)
    params, model = _params(name, rc, pc)
    toks, emb = _inputs(rc, s=17, seed=2)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    r_lg0, r_cache = RL.prefill(params, jt[:, :16], rc, max_len=32,
                                embeds=_opt(emb, jnp.asarray))
    r_lg, _ = RL.decode_step(params, r_cache, jt[:, 16:17], rc)
    with torch.no_grad():
        full, _ = model.forward(tt, embeds=_opt(emb, torch.from_numpy))
        lg0, cache = model.prefill(tt[:, :16], 32,
                                   embeds=_opt(emb, torch.from_numpy))
        assert int(cache["pos"]) == 16
        assert tuple(cache["kv"]["k"].shape) == tuple(
            r_cache["kv"]["k"].shape)
        lg, cache2 = model.decode_step(cache, tt[:, 16:17])
    assert int(cache2["pos"]) == 17 and int(cache["pos"]) == 16
    v = pc.vocab_size
    if dtype == "float32":
        np.testing.assert_allclose(lg0[:, :v].numpy(),
                                   np.asarray(r_lg0)[:, :v], **FP32_TOL)
        np.testing.assert_allclose(lg[:, :v].numpy(),
                                   np.asarray(r_lg)[:, :v], **FP32_TOL)
        np.testing.assert_allclose(
            cache["kv"]["k"].numpy(), np.asarray(r_cache["kv"]["k"]),
            **FP32_TOL)
    for got, want in ((lg0, full[:, 15]), (lg, full[:, 16])):
        err = float((_lsm(got.float()[:, :v])
                     - _lsm(want.float()[:, :v])).abs().max())
        assert err < BF16_LOGSOFTMAX, err


def test_sliding_window_ring_buffer_matches_reference():
    """The decode ring buffer of a sliding-window config, ported as it is
    (the mixtral window on a dense model): 6 steps past a window of 4."""
    rc, pc = _configs("qwen2-narrow", "float32")
    rc = dataclasses.replace(rc, sliding_window=4)
    pc = dataclasses.replace(pc, sliding_window=4)
    params, model = _params("qwen2-narrow", dataclasses.replace(
        rc, sliding_window=None), pc)
    toks, _ = _inputs(rc, s=12, seed=3)
    r_lg, r_cache = RL.prefill(params, jnp.asarray(toks[:, :6]), rc,
                               max_len=16)
    p = model.tree()
    with torch.no_grad():
        lg, cache = PL.prefill(p, torch.from_numpy(toks[:, :6]), pc,
                               max_len=16)
        assert cache["kv"]["k"].shape[2] == 4
        for t in range(6, 12):
            r_lg, r_cache = RL.decode_step(params, r_cache,
                                           jnp.asarray(toks[:, t:t + 1]), rc)
            lg, cache = PL.decode_step(p, cache,
                                       torch.from_numpy(toks[:, t:t + 1]), pc)
            v = pc.vocab_size
            np.testing.assert_allclose(lg[:, :v].numpy(),
                                       np.asarray(r_lg)[:, :v], **FP32_TOL)
    np.testing.assert_allclose(cache["kv"]["v"].numpy(),
                               np.asarray(r_cache["kv"]["v"]), **FP32_TOL)
