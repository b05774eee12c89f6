"""The port's direct scheme oracles and its example entry points
(``repro_torch.core.schemes.forward``, ``optimize.forward_optimized``,
``repro_torch.core.__all__`` and ``repro_torch.examples``) against the
reference's, on the CPU.

Inputs are made from numpy seeds.  The reference's examples are loaded
from ``examples/`` by path and run as they are, their ``print`` lines
read back where they return nothing.  Bounds:

* the oracles (3 wavelets x 6 schemes, raw and Section 5, 64x96, seed
  0) within ``CROSS_TOL`` of the reference's and of the port's own
  ``sep-lifting`` forward (all six schemes are one transform);
* the codec's PSNR rows within 0.01 dB of the reference example's (the
  same numpy image; other reduction orders move the coefficients by
  ~1e-7); the served codec bit for bit against the port's own direct
  ``dwt2``/``idwt2`` at the server's configuration (the reference's
  server is not a parity target: its tests fail on this machine);
* the quickstart's step, op and launch counts equal to the reference's;
* ``serve_lm``'s teacher-forced logits within 1e-4 of the reference's
  prefill and decode steps (SMOKE, float32, the reference's parameters
  carried across);
* ``train_lm``: the model and run configurations its flags make equal
  to the reference example's; three steps at SMOKE from the reference's
  initial state, held as ``tests/test_torch_train_step.py`` holds a
  train step (losses ``rtol=1e-5``; AdamW moments per leaf 1e-4 of the
  leaf's scale; parameters within one learning rate);
* the compression demo's byte lines equal to the reference's, text for
  text.
"""
import dataclasses
import importlib.util
import re
import sys
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as RC
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.configs import registry as RR
from repro.core import optimize as RO
from repro.core import schemes as RS
from repro.engine import get_plan as r_get_plan
from repro.kernels import ops as RK
from repro.models import lm as RL
from repro.runtime import steps as RSt

import repro_torch
import repro_torch.core as PC
from repro_torch import convert, pytree
from repro_torch.configs import registry as PR
from repro_torch.core import optimize as PO
from repro_torch.core import schemes as PSc
from repro_torch.examples import dwt_image_codec as PD
from repro_torch.examples import quickstart as PQ
from repro_torch.examples import serve_lm as PSL
from repro_torch.examples import train_lm as PTL
from repro_torch.examples import wavelet_compression_demo as PW
from repro_torch.runtime import steps as PSt

ROOT = Path(__file__).resolve().parents[1]
CROSS_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_differential.py
PSNR_DB = 0.01
LOGITS_ATOL = 1e-4
LEAF_RTOL = 1e-4
WAVELETS = ("cdf53", "cdf97", "dd137")
ORACLES = {"forward": (RS.forward, PSc.forward),
           "forward_optimized": (RO.forward_optimized,
                                 PO.forward_optimized)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    small ops on a thread per core in every worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_example(name):
    """``examples/<name>.py`` as a module, loaded by path (unedited)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# The direct scheme oracles and repro_torch.core's exports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).standard_normal((64, 96)) \
        .astype(np.float32)


@pytest.mark.parametrize("oracle", sorted(ORACLES))
@pytest.mark.parametrize("scheme", PSc.SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_oracle_matches_reference(image, wavelet, scheme, oracle):
    ref_fn, port_fn = ORACLES[oracle]
    want = ref_fn(jnp.asarray(image), wavelet, scheme)
    got = port_fn(torch.from_numpy(image), wavelet, scheme)
    # every scheme, optimised or not, computes sep-lifting's transform
    lifting = PSc.forward(torch.from_numpy(image), wavelet, "sep-lifting")
    assert len(got) == 4
    for w, g, l in zip(want, got, lifting):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), **CROSS_TOL)
        np.testing.assert_allclose(_np(g), _np(l), **CROSS_TOL)


@pytest.mark.parametrize("name", RC.__all__)
def test_core_exports_every_reference_name(name):
    assert name in PC.__all__
    assert getattr(PC, name) is not None


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

ROW = re.compile(r"^\s*([\d.]+)%\s+([\d.]+)$")


def _rows(text):
    return [(float(m.group(1)) / 100, float(m.group(2)))
            for m in map(ROW.match, text.splitlines()) if m]


@pytest.fixture(scope="module")
def codec_ref():
    return reference_example("dwt_image_codec")


def _assert_rows(got, want):
    assert [k for k, _ in got] == pytest.approx([k for k, _ in want])
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= PSNR_DB, (got, want)


def test_codec_image_and_psnr_match_reference(codec_ref):
    img = codec_ref.synthetic_photo(128)
    port = PD.synthetic_photo(128, device="cpu")
    np.testing.assert_array_equal(_np(port), np.asarray(img))
    noisy = np.asarray(img) + np.random.default_rng(1).standard_normal(
        img.shape).astype(np.float32) * 0.01
    assert abs(PD.psnr(port, torch.from_numpy(noisy))
               - codec_ref.psnr(img, jnp.asarray(noisy))) <= PSNR_DB


def test_codec_sweep_matches_reference(codec_ref, monkeypatch, capsys):
    photo = codec_ref.synthetic_photo
    monkeypatch.setattr(codec_ref, "synthetic_photo",
                        lambda n=512, seed=0: photo(128, seed))
    codec_ref.main()
    want = _rows(capsys.readouterr().out)
    got = PD.main_sweep(128, device="cpu")
    assert len(want) == 5
    _assert_rows(got["rows"], want)
    assert got["err"] < 1e-4


def test_codec_tiled_matches_reference(codec_ref, capsys):
    codec_ref.main_tiled(128, 64)
    want = _rows(capsys.readouterr().out)
    got = PD.main_tiled(128, 64, device="cpu")
    assert len(want) == 2
    _assert_rows(got["rows"], want)
    # the streamed pyramid is the monolithic one at the stream's fuse
    mono = repro_torch.dwt2(PD.synthetic_photo(128, device="cpu"),
                            levels=4, fuse="levels", device="cpu",
                            **PD.CODEC)
    np.testing.assert_array_equal(got["pyramid"].ll, _np(mono.ll))
    for dd, mm in zip(got["pyramid"].details, mono.details):
        for d, m in zip(dd, mm):
            np.testing.assert_array_equal(d, _np(m))
    assert got["err"] < 1e-4


def test_served_codec_equals_direct_calls():
    got = PD.main_serve(128, device="cpu")
    kw = dict(backend="cuda", fuse="levels", device="cpu", **PD.CODEC)
    assert len(got["tiles"]) == 4 and len(got["rows"]) == 2
    recs = []
    for tile, served in zip(got["tiles"], got["pyramids"]):
        direct = repro_torch.dwt2(np.ascontiguousarray(tile), levels=3, **kw)
        np.testing.assert_array_equal(served.ll, _np(direct.ll))
        for dd, mm in zip(served.details, direct.details):
            for d, m in zip(dd, mm):
                np.testing.assert_array_equal(d, _np(m))
        recs.append(_np(repro_torch.idwt2(served, **kw)))
    top, bottom = np.hstack(recs[:2]), np.hstack(recs[2:])
    np.testing.assert_array_equal(got["reconstruction"],
                                  np.vstack([top, bottom]))
    assert got["stats"]["served"] >= 16 and got["err"] < 1e-4


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart():
    return PQ.run(64, device="cpu")


@pytest.mark.parametrize("scheme", PSc.SCHEMES)
def test_quickstart_scheme_counts_match_reference(quickstart, scheme):
    row = next(r for r in quickstart["schemes"] if r["scheme"] == scheme)
    sch = RS.build_scheme("cdf97", scheme)
    assert (row["steps"], row["ops"]) == (sch.num_steps, sch.num_ops)
    assert row["err"] < 1e-4
    first = quickstart["schemes"][0]["ll"]
    np.testing.assert_allclose(_np(row["ll"]), _np(first), **CROSS_TOL)


def test_quickstart_optimized_counts_match_reference(quickstart):
    want = [dict(scheme=s, ops=RS.build_scheme("cdf97", s).num_ops,
                 ops_optimized=RO.build_optimized("cdf97", s).num_ops,
                 steps=RS.build_scheme("cdf97", s).num_steps,
                 steps_optimized=RO.build_optimized("cdf97", s).num_steps)
            for s in ("ns-conv", "ns-polyconv", "ns-lifting")]
    assert quickstart["optimized"] == want


def test_quickstart_kernel_section_matches_reference(quickstart):
    kernel = quickstart["kernel"]
    for scheme, got in (("sep-conv", kernel["sep_conv"]),
                        ("ns-conv", kernel["ns_conv"])):
        want = RK.scheme_stats("cdf97", scheme, False, (64, 64))
        assert (got["steps"], got["launches"], got["ops"]) == \
            (want["steps"], want["pallas_calls"], want["ops"])
    img = PQ.make_test_image(64, device="cpu")
    want = RO.forward_optimized(jnp.asarray(_np(img)), "cdf97",
                                "ns-polyconv")
    for g, w in zip(kernel["subbands"], want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **CROSS_TOL)


def test_quickstart_engine_plan_matches_reference(quickstart):
    engine = quickstart["engine"]
    plan = r_get_plan(wavelet="cdf97", scheme="ns-polyconv", levels=3,
                      shape=(8, 64, 64), dtype="float32", backend="pallas",
                      fuse="levels")
    assert (engine["steps"], engine["launches"]) == \
        (plan.num_steps, plan.pallas_calls)
    assert engine["stats"]["hits"] == engine["first"]["hits"] + 1
    assert engine["stats"]["misses"] == engine["first"]["misses"]
    assert engine["ll_shape"] == (8, 8, 8) and engine["err"] < 1e-4


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

SERVE = dict(batch=2, prompt=8, new_tokens=6)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "mixtral-8x7b",
                                  "whisper-medium"))
def test_serve_lm_teacher_forced_logits_match_reference(arch):
    rc, _ = RR.get_config(arch, smoke=True)
    pc, _ = PR.get_config(arch, smoke=True)
    rc = dataclasses.replace(rc, dtype="float32")
    pc = dataclasses.replace(pc, dtype="float32")
    b, p, n = SERVE["batch"], SERVE["prompt"], SERVE["new_tokens"]
    rparams = jax.jit(RL.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rc)
    params = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pc, device="cpu").tree()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, rc.vocab_size, (b, p)).astype(np.int32)
    teacher = rng.integers(0, rc.vocab_size, (b, n - 1)).astype(np.int32)
    enc = None
    decode = jax.jit(lambda prm, c, t: RSt.decode_step(prm, c, t, rc))
    want = []
    if rc.family == "encdec":
        enc = (rng.standard_normal((b, p, rc.d_model)) * 0.02) \
            .astype(np.float32)
        cache = jax.jit(RL.whisper_prefill, static_argnums=(2, 3))(
            rparams, jnp.asarray(enc), rc, b)
    else:
        logits, cache = jax.jit(RL.prefill, static_argnums=(2, 3))(
            rparams, jnp.asarray(prompts), rc, p + n)
        want.append(logits)
    for i in range(n - 1):
        logits, cache = decode(rparams, cache,
                               jnp.asarray(teacher[:, i:i + 1]))
        want.append(logits)
    got = PSL.generate(
        params, pc, torch.from_numpy(prompts), n,
        enc=None if enc is None else torch.from_numpy(enc),
        teacher=torch.from_numpy(teacher))
    assert got["tokens"].shape == (b, n)
    assert len(got["logits"]) == len(want)
    v = rc.vocab_size
    for g, w in zip(got["logits"], want):
        np.testing.assert_allclose(_np(g)[..., :v], np.asarray(w)[..., :v],
                                   rtol=0, atol=LOGITS_ATOL)


# ---------------------------------------------------------------------------
# train_lm and the compression demo
# ---------------------------------------------------------------------------

def _leaves_close(ref_tree, got_tree, rtol):
    ref = jax.tree_util.tree_leaves(ref_tree)
    got = pytree.leaves(got_tree)
    assert len(ref) == len(got)
    for want, have in zip(ref, got):
        want = np.asarray(want, np.float64)
        have = _np(have).astype(np.float64)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(want - have).max()) <= rtol * scale


def _train_lm_reference(flags, tmp_path, monkeypatch, run_it):
    """The reference example's ``main`` on ``flags`` (float32 compute:
    in bfloat16 the packages round apart, ``tests/test_torch_lm.py``),
    its ``train`` call captured and run when ``run_it`` (else answered
    with one loss); the port's example gets the same registry."""
    ref = reference_example("train_lm")
    seen = {}
    real_train = ref.train

    def train(cfg, run, pipe, shape, num_steps, log_every=10, **kw):
        seen.update(cfg=cfg, run=run, result=real_train(
            cfg, run, pipe, shape, num_steps, log_every=0, **kw)
            if run_it else types.SimpleNamespace(losses=[0.0]))
        return seen["result"]

    def float32(reg):
        def get_config(arch, smoke=False):
            cfg, run = reg.get_config(arch, smoke)
            return dataclasses.replace(cfg, dtype="float32"), run
        return get_config

    for mod, reg in ((ref, RR), (PTL, PR)):
        monkeypatch.setattr(mod, "get_config", float32(reg))
    monkeypatch.setattr(ref, "train", train)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *flags, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    ref.main()
    return seen


@pytest.mark.parametrize("arch", ("qwen2-100m", "qwen2-0.5b"))
@pytest.mark.parametrize("compress", (False, True),
                         ids=("plain", "compressed"))
def test_train_lm_configs_match_reference(arch, compress, tmp_path,
                                          monkeypatch):
    flags = ["--steps", "300", "--arch", arch] + \
        (["--compress"] if compress else [])
    seen = _train_lm_reference(flags, tmp_path, monkeypatch, run_it=False)
    cfg, run = PTL.configs(arch, 300, compress, str(tmp_path / "ref"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    assert dataclasses.asdict(run) == dataclasses.asdict(seen["run"])


def test_train_lm_matches_reference(tmp_path, monkeypatch, capsys):
    """Three steps of both examples at SMOKE from the reference's
    initial state (plain: the compressed step's parity is
    ``tests/test_torch_train_step.py``'s, whose reference step compiles
    once for it)."""
    flags = ["--steps", "3", "--arch", "qwen2-0.5b", "--batch", "2",
             "--seq", "32"]
    # the reference's initial state, jitted (op by op it compiles each
    # random draw); both packages start from it
    monkeypatch.setattr(RSt, "init_train_state", jax.jit(
        RSt.init_train_state, static_argnums=(1, 2)))
    seen = _train_lm_reference(flags, tmp_path, monkeypatch, run_it=True)
    capsys.readouterr()
    rc, rrun = seen["cfg"], seen["run"]
    init = RSt.init_train_state(jax.random.PRNGKey(rrun.seed), rc, rrun)
    cfg, run = PTL.configs("qwen2-0.5b", 3, False, str(tmp_path / "port"))
    start = convert.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, init), cfg, device="cpu")
    monkeypatch.setattr(PSt, "init_train_state",
                        lambda gen, cfg, run, device: start)
    got = PTL.run_training(3, "qwen2-0.5b", 2, 32, False,
                           str(tmp_path / "port"), device="cpu",
                           log_every=0)
    res = got["result"]
    np.testing.assert_allclose(res.losses, seen["result"].losses, rtol=1e-5)
    assert got["first10"] == pytest.approx(np.mean(res.losses))
    final, step = RCheckpointer(str(tmp_path / "ref")).restore(init)
    state = res.state
    assert step == 3 and int(state.step) == 3 and state.efb == {}
    _leaves_close(final.opt.mu, state.opt.mu, LEAF_RTOL)
    _leaves_close(final.opt.nu, state.opt.nu, LEAF_RTOL)
    for want, have in zip(jax.tree_util.tree_leaves(final.params),
                          pytree.leaves(state.params)):
        assert float(np.abs(np.asarray(want) - _np(have)).max()) <= run.lr


def test_compression_demo_byte_lines_match_reference(monkeypatch, capsys):
    ref = reference_example("wavelet_compression_demo")
    monkeypatch.setattr(ref, "run_one", lambda *a, **k: [0.0] * 10)
    monkeypatch.setattr(sys, "argv", ["wavelet_compression_demo.py"])
    ref.main()
    want = capsys.readouterr().out.splitlines()[:2]
    cfg, _ = PR.get_config("minitron-8b", smoke=True)
    got = PW.byte_lines(cfg)
    assert capsys.readouterr().out.splitlines()[:2] == want
    assert got["raw_bytes"] == cfg.n_params() * 4
    assert got["dwt2_bytes"] == cfg.n_params() * 4 / 16


def test_compression_demo_runs_three_trainings(tmp_path):
    out = PW.run_demo(2, device="cpu", ckpt_root=str(tmp_path))
    assert sorted(out["losses"]) == ["dwt:1", "dwt:2", "none"]
    assert all(len(v) == 2 and np.isfinite(v).all()
               for v in out["losses"].values())
    base, comp = out["losses"]["none"], out["losses"]["dwt:2"]
    assert out["gap_dwt2"] == pytest.approx((sum(comp) - sum(base)) / 10)


# ---------------------------------------------------------------------------
# The card by default
# ---------------------------------------------------------------------------

ENTRY_POINTS = {
    "quickstart": lambda tmp: PQ.run(16),
    "dwt_image_codec": lambda tmp: PD.main_sweep(16, levels=2),
    "dwt_image_codec_tiled": lambda tmp: PD.main_tiled(32, 16, levels=2),
    "dwt_image_codec_serve": lambda tmp: PD.main_serve(32, tile=16,
                                                       levels=2),
    "train_lm": lambda tmp: PTL.run_training(1, "qwen2-0.5b", 1, 8,
                                             ckpt_dir=str(tmp)),
    "wavelet_compression_demo": lambda tmp: PW.run_demo(
        1, ckpt_root=str(tmp)),
    "serve_lm": lambda tmp: PSL.serve(batch=1, prompt_len=4,
                                      new_tokens=2),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_examples_default_to_the_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path)
