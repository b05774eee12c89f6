"""Gradient compression of the port (``repro_torch.core.compression``)
against the reference's (``repro.core.compression``).

The same numpy inputs, made from a seed, go through both packages.  The
port runs on the CPU, so its transforms take K1's plain version (the
default backend ``"cuda"`` on CPU tensors); the reference runs its
``jnp`` transforms.  Held to the reference's cross-backend bound
``CROSS_TOL`` (``tests/test_differential.py``).  The reference's own
tests (``tests/test_compression.py``) are repeated for the port below.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import compression as RC
from repro.models import lm as RL
from repro.configs.qwen2_0_5b import FULL as R_QWEN

import repro_torch as P
from repro_torch import engine, pytree
from repro_torch.core import compression as PC
from repro_torch.kernels import tap_window as TW

CROSS_TOL = dict(rtol=2e-4, atol=2e-5)
CPU = "cpu"


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("shape", [(1000, 37), (300, 7), (128, 8)])
@pytest.mark.parametrize("levels", [1, 2])
def test_compress_decompress_match_reference(shape, levels):
    g = np.random.default_rng(sum(shape) + levels).standard_normal(
        shape).astype(np.float32)
    for phase in sorted({0, 1, RC.n_phases(levels) - 1}):
        want = RC.compress(jnp.asarray(g), phase, levels)
        got = PC.compress(_t(g), phase, levels)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), np.asarray(want), **CROSS_TOL)
        # the same slice into both inverses
        back_ref = RC.decompress(want, phase, shape, levels)
        back = PC.decompress(_t(want), phase, shape, levels)
        np.testing.assert_allclose(_np(back), np.asarray(back_ref),
                                   **CROSS_TOL)


def test_compression_runs_k1s_plain_version_on_the_cpu():
    """On a CPU tensor the port's default backend "cuda" runs K1's plain
    version: the transform counts no kernel launch, and plans are the
    "cuda" backend's at fuse "none"."""
    g = _t(np.random.default_rng(4).standard_normal((96, 40)))
    engine.clear_plan_cache()
    before = TW.KERNEL.launches
    PC.decompress(PC.compress(g, 3, 2), 3, g.shape, 2)
    assert TW.KERNEL.launches == before
    plan = engine.get_plan(scheme=PC.SCHEME, levels=2,
                           shape=PC.tile_shape(g.numel(), 2), device=CPU)
    assert plan.backend.name == "cuda" and plan.key.fuse == "none"
    assert plan.launches == 4


def _narrow_qwen2():
    return dataclasses.replace(R_QWEN, n_layers=2, d_model=112, d_ff=192,
                               vocab_size=1000)


@pytest.mark.parametrize("step", [0, 5])
def test_compress_with_feedback_over_a_qwen2_tree(step):
    """Per-leaf compression of a narrow qwen2 parameter tree (stacked
    leaves, so the reference's tiles) with a nonzero error state."""
    cfg = _narrow_qwen2()
    shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: RL.init_params(jax.random.PRNGKey(0), cfg)))
    rng = np.random.default_rng(step)
    grads = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32) * 1e-2, shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    errors = jax.tree_util.tree_map(
        lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32),
        grads)
    ref_g, ref_e = RC.compress_with_feedback(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, errors), step, levels=2)
    conv = lambda tree: pytree.tree_map(_t, tree)
    got_g, got_e = PC.compress_with_feedback(conv(grads), conv(errors), step,
                                             levels=2)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_g)[0]]
    assert paths == [pytree.keystr(p)
                     for p, _ in pytree.leaves_with_path(got_g)]
    for want, got in zip(jax.tree_util.tree_leaves(ref_g),
                         pytree.leaves(got_g)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **CROSS_TOL)
    for want, got in zip(jax.tree_util.tree_leaves(ref_e),
                         pytree.leaves(got_e)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **CROSS_TOL)


def test_qwen2_tiles_plan_at_full_width():
    """The tiles of qwen2-0.5b's 14 leaves (the tied embedding is a
    (537600, 256) image) plan on the "cuda" backend: 4 launches each way
    at 2 levels, and the window fits the kernel's int32 tile index."""
    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.models import lm
    params = lm.init_params(None, FULL, "meta")  # shapes only
    tiles = sorted({PC.tile_shape(p.numel(), 2)
                    for p in pytree.leaves(params)})
    assert (537600, 256) in tiles and (408576, 256) in tiles
    assert len(pytree.leaves(params)) == 14
    for shape in tiles:
        plan = engine.get_plan(scheme=PC.SCHEME, levels=2, shape=shape,
                               device=CPU)
        assert plan.launches == 4
        for spec in plan.level_specs:
            for win in spec.fwd_windows + spec.inv_windows:
                assert win.tiles((1,) + spec.plane_shape) < 2 ** 31


def _chip_families():
    """``chip_smoke.FAMILIES``: the archs and depth cuts phase 3h trains
    on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_families",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAMILIES


@pytest.mark.parametrize("fam", _chip_families(), ids=lambda f: f["arch"])
def test_family_tiles_fit_the_kernel_index_math(fam):
    """Every tile of every tree phase 3h compresses on the card (each arch
    at full width, depth cut as the script cuts it) plans 4 K1 launches
    each way at 2 levels, with the K1 tile count under the wrapper's int32
    guard and every plane's elements under 2^31; mixtral's expert leaves
    are the tallest tiles K1 is given, (1835008, 256)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg, _ = get_config(fam["arch"])
    if fam["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=fam["layers"])
    params = lm.init_params(None, cfg, "meta")  # shapes only
    tiles = sorted({PC.tile_shape(p.numel(), 2)
                    for p in pytree.leaves(params)})
    for shape in tiles:
        plan = engine.get_plan(scheme=PC.SCHEME, levels=2, shape=shape,
                               device=CPU)
        assert plan.launches == 4
        for spec in plan.level_specs:
            hp, wp = spec.plane_shape
            assert hp * wp < 2 ** 31
            for win in spec.fwd_windows + spec.inv_windows:
                assert win.tiles((1, hp, wp)) < 2 ** 31
    if fam["arch"] == "mixtral-8x7b":
        assert max(tiles) == (1835008, 256)
        assert dict(pytree.leaves_with_path(params))[
            (("key", "blocks"), ("key", "moe"), ("key", "gate"))
        ].shape == (1, 8, 4096, 14336)


# ---------------------------------------------------------------------------
# The reference's tests (tests/test_compression.py), for the port
# ---------------------------------------------------------------------------

def test_compress_ratio():
    g = _t(np.random.default_rng(0).standard_normal((1000, 37)))
    for levels in (1, 2):
        c = PC.compress(g, 0, levels=levels)
        assert c.numel() <= g.numel() / (4 ** levels) * 1.6


def test_phases_partition_identity():
    rng = np.random.default_rng(1)
    g = _t(rng.standard_normal((300, 7)))
    for levels in (1, 2):
        total = torch.zeros_like(g)
        for p in range(PC.n_phases(levels)):
            total = total + PC.decompress(PC.compress(g, p, levels), p,
                                          g.shape, levels)
        np.testing.assert_allclose(_np(total), _np(g), rtol=1e-3, atol=1e-4)


def test_projection_idempotent_on_tiles():
    rng = np.random.default_rng(2)
    g = _t(rng.standard_normal((128, 8)))
    tile, _ = PC._tile_2d(g, 1)
    kw = dict(wavelet="cdf97", scheme=PC.SCHEME, device=CPU)
    flat = P.flatten_pyramid(P.dwt2(tile, levels=1, **kw))
    rows = flat.shape[0] // 4
    mask = torch.zeros_like(flat)
    mask[rows:2 * rows] = flat[rows:2 * rows]
    rec = P.idwt2(P.unflatten_pyramid(mask, 1), **kw)
    flat2 = P.flatten_pyramid(P.dwt2(rec, levels=1, **kw))
    np.testing.assert_allclose(_np(flat2), _np(mask), rtol=2e-3, atol=2e-4)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_linearity(seed):
    rng = np.random.default_rng(seed)
    a = _t(rng.standard_normal((300, 7)))
    b = _t(rng.standard_normal((300, 7)))
    ca = PC.compress(a, 2, 2)
    cb = PC.compress(b, 2, 2)
    cab = PC.compress(a + b, 2, 2)
    np.testing.assert_allclose(_np(ca + cb), _np(cab), rtol=1e-4, atol=1e-4)


def test_error_feedback_transmits_everything():
    rng = np.random.default_rng(1)
    g = {"w": _t(rng.standard_normal((257, 5)))}
    e = PC.init_error_feedback(g)
    cycle = PC.n_phases(2)
    last_cycle = torch.zeros_like(g["w"])
    for step in range(4 * cycle):  # 3 warmup cycles + 1 measured
        out, e = PC.compress_with_feedback(g, e, step, levels=2)
        if step >= 3 * cycle:
            last_cycle = last_cycle + out["w"]
    rel = float(torch.linalg.norm(last_cycle / cycle - g["w"])
                / torch.linalg.norm(g["w"]))
    assert rel < 0.05, rel


def test_error_feedback_residual_bounded():
    rng = np.random.default_rng(2)
    g = {"w": _t(rng.standard_normal((64, 64)))}
    e = PC.init_error_feedback(g)
    norms = []
    for step in range(16 * PC.n_phases(1)):
        _, e = PC.compress_with_feedback(g, e, step, levels=1)
        norms.append(float(torch.linalg.norm(e["w"])))
    cyc = PC.n_phases(1)
    assert max(norms[-cyc:]) < 1.05 * max(norms[-2 * cyc:-cyc]), \
        norms[-3 * cyc:]
    linear = len(norms) / cyc * float(torch.linalg.norm(g["w"]))
    assert norms[-1] < 0.5 * linear


def test_compressed_bytes_ratio():
    assert PC.compressed_bytes_ratio(2) == 1 / 16
    assert PC.compressed_bytes_ratio(2) == RC.compressed_bytes_ratio(2)
