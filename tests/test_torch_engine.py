"""The port's 2-D main path end to end, against the reference package.

``repro_torch.dwt2`` / ``idwt2`` on ``device="cpu"`` through both port
backends ("torch", and "cuda", which runs the window kernel's plain
version on CPU tensors), at levels 1-3, batched, with odd and prime
multiples of ``2^levels``, against the reference's ``dwt2`` (jnp and
pallas) and its filter-bank oracle ``dwt2_ref``; plus the plan cache,
the launch model, the geometry error text, the device default and the
reference features that raise until they are ported.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import transform as JT
from repro.core.schemes import SCHEMES
from repro.engine.plan import validate_image_geometry as j_validate
from repro.kernels import ref as JR

import repro_torch as R
from repro_torch import engine as TE
from repro_torch.convert import pyramid_from_numpy
from repro_torch.kernels import ref as TR

# tests/test_differential.py ROUNDTRIP_TOL / CROSS_TOL
ROUNDTRIP_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
                 "float16": dict(rtol=2e-2, atol=2e-3)}
CROSS_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "float16": dict(rtol=2e-2, atol=2e-3)}
BACKENDS = ("torch", "cuda")


def _image(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _planes_np(pyr):
    """Pyramid -> [LL, HL_L, LH_L, HH_L, ..., HH_1] as float32 arrays."""
    planes = [pyr.ll] + [d for det in pyr.details for d in det]
    return [np.asarray(p.float() if isinstance(p, torch.Tensor) else p,
                       dtype=np.float32) for p in planes]


def _assert_pyramids_close(got, ref, tol):
    g, r = _planes_np(got), _planes_np(ref)
    assert [a.shape for a in g] == [b.shape for b in r]
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# end-to-end parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels,mult", [(1, 7), (2, 5), (3, 3)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dwt2_matches_reference_jnp(scheme, levels, mult):
    """Batched odd/prime-multiple shapes, fuse none and scheme, both port
    backends, forward vs the reference's jnp backend and round trip."""
    div = 1 << levels
    x = _image((2, mult * div, (mult + 2) * div), seed=levels)
    for fuse in ("none", "scheme"):
        ref = JT.dwt2(x, wavelet="cdf97", levels=levels, scheme=scheme,
                      backend="jnp", fuse=fuse)
        for backend in BACKENDS:
            kw = dict(wavelet="cdf97", scheme=scheme, backend=backend,
                      fuse=fuse, device="cpu")
            pyr = R.dwt2(torch.from_numpy(x), levels=levels, **kw)
            _assert_pyramids_close(pyr, ref, CROSS_TOL["float32"])
            rec = R.idwt2(pyr, **kw)
            np.testing.assert_allclose(rec.numpy(), x,
                                       **ROUNDTRIP_TOL["float32"])


@pytest.mark.parametrize("wavelet", ("cdf53", "cdf97", "dd137"))
def test_dwt2_matches_reference_pallas(wavelet):
    """The reference's Pallas path (interpret mode) on a batched 3-level
    pyramid with prime plane multiples vs the port's cuda backend."""
    x = _image((2, 3 * 8, 5 * 8), seed=11)
    ref = JT.dwt2(x, wavelet=wavelet, levels=3, scheme="ns-polyconv",
                  backend="pallas", fuse="scheme")
    pyr = R.dwt2(x, wavelet=wavelet, levels=3, scheme="ns-polyconv",
                 backend="cuda", fuse="scheme", device="cpu")
    _assert_pyramids_close(pyr, ref, CROSS_TOL["float32"])


@pytest.mark.parametrize("wavelet", ("cdf53", "cdf97", "dd137"))
@pytest.mark.parametrize("backend", BACKENDS)
def test_dwt2_matches_filter_bank_oracles(backend, wavelet):
    """One level against the port's Mallat oracle and the reference's."""
    x = _image((3, 14, 22), seed=5)
    pyr = R.dwt2(x, wavelet=wavelet, backend=backend, device="cpu")
    got = [pyr.ll, *pyr.details[0]]
    ours = TR.dwt2_ref(torch.from_numpy(x), wavelet)
    theirs = JR.dwt2_ref(x, wavelet)
    for g, o, t in zip(got, ours, theirs):
        np.testing.assert_allclose(g.numpy(), o.numpy(),
                                   **CROSS_TOL["float32"])
        np.testing.assert_allclose(o.numpy(), np.asarray(t),
                                   **CROSS_TOL["float32"])
    rec = TR.idwt2_ref(tuple(ours), wavelet)
    np.testing.assert_allclose(rec.numpy(), x, **ROUNDTRIP_TOL["float32"])


@pytest.mark.parametrize("tap_opt", ("off", "exact", "full"))
@pytest.mark.parametrize("optimize", (False, True))
def test_dwt2_tap_opt_and_optimize_agree(optimize, tap_opt):
    x = _image((2, 24, 40), seed=6)
    ref = JT.dwt2(x, levels=2, scheme="sep-polyconv", backend="jnp",
                  optimize=optimize, tap_opt=tap_opt)
    for backend in BACKENDS:
        kw = dict(scheme="sep-polyconv", backend=backend, optimize=optimize,
                  tap_opt=tap_opt, device="cpu")
        pyr = R.dwt2(x, levels=2, **kw)
        _assert_pyramids_close(pyr, ref, CROSS_TOL["float32"])
        np.testing.assert_allclose(R.idwt2(pyr, **kw).numpy(), x,
                                   **ROUNDTRIP_TOL["float32"])


def test_cuda_off_and_exact_are_bit_identical():
    """Under tap_opt="off" the kernel backend runs the lowered raw walk,
    which the compiler's "exact" level leaves bit for bit unchanged."""
    x = torch.from_numpy(_image((2, 24, 40), seed=7))
    a = R.dwt2(x, levels=2, backend="cuda", tap_opt="off", device="cpu")
    b = R.dwt2(x, levels=2, backend="cuda", tap_opt="exact", device="cpu")
    for p, q in zip(_planes_np(a), _planes_np(b)):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("backend", BACKENDS)
def test_float16_io_and_bf16_compute(backend):
    # fuse="scheme": one launch per level rounds to the I/O dtype once per
    # level, as the reference's jnp backend does (fuse="none" also rounds
    # between the steps of a level, as the reference's Pallas path does)
    x = _image((2, 16, 24), seed=8)
    ref = JT.dwt2(x.astype(np.float16), levels=2, backend="jnp")
    pyr = R.dwt2(torch.from_numpy(x).half(), levels=2, backend=backend,
                 fuse="scheme", device="cpu")
    assert pyr.ll.dtype == torch.float16
    _assert_pyramids_close(pyr, ref, CROSS_TOL["float16"])
    rec = R.idwt2(pyr, backend=backend, fuse="scheme", device="cpu")
    np.testing.assert_allclose(rec.float().numpy(), x,
                               **ROUNDTRIP_TOL["float16"])
    # bf16 arithmetic: held to the reference's own bf16-compute result
    bf_ref = JT.dwt2(x, levels=2, backend="jnp", compute_dtype="bfloat16")
    bf = R.dwt2(x, levels=2, backend=backend, compute_dtype="bfloat16",
                device="cpu")
    assert bf.ll.dtype == torch.float32
    _assert_pyramids_close(bf, bf_ref, CROSS_TOL["float16"])


def test_idwt2_of_a_reference_pyramid():
    """A pyramid made by the reference, carried across as arrays."""
    x = _image((2, 32, 48), seed=9)
    ref = JT.dwt2(x, levels=3, backend="jnp")
    pyr = pyramid_from_numpy(np.asarray(ref.ll),
                             [[np.asarray(d) for d in det]
                              for det in ref.details])
    for backend in BACKENDS:
        rec = R.idwt2(pyr, backend=backend, device="cpu")
        np.testing.assert_allclose(rec.numpy(), x,
                                   **ROUNDTRIP_TOL["float32"])


# ---------------------------------------------------------------------------
# plan cache and launch model
# ---------------------------------------------------------------------------

def test_plan_cache_hit_miss_semantics():
    cache = TE.PlanCache(maxsize=4)
    kw = dict(wavelet="cdf97", scheme="ns-polyconv", levels=2,
              dtype="float32", backend="cuda", device="cpu", cache=cache)
    p1 = TE.get_plan(shape=(8, 32, 32), **kw)
    assert cache.stats() == {"hits": 0, "misses": 1, "size": 1, "maxsize": 4}
    assert TE.get_plan(shape=(8, 32, 32), **kw) is p1
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    TE.get_plan(shape=(4, 32, 32), **kw)
    assert cache.stats()["misses"] == 2
    for n in (64, 128, 256):
        TE.get_plan(shape=(n, n), **kw)
    assert len(cache) == 4 and p1.key not in cache
    assert p1.key.device == "cpu"


def test_dwt2_uses_global_plan_cache():
    R.clear_plan_cache()
    x = torch.from_numpy(_image((2, 16, 16), seed=1))
    R.dwt2(x, wavelet="cdf53", device="cpu")
    before = R.plan_cache_stats()
    R.dwt2(x, wavelet="cdf53", device="cpu")
    after = R.plan_cache_stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]


@pytest.mark.parametrize("fuse", ("none", "scheme", "levels"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_launches_equal_reference_pallas_calls(scheme, fuse):
    for levels in (1, 2, 3):
        shape = (8, 64, 64)
        ref = JE.get_plan(shape=shape, levels=levels, scheme=scheme,
                          backend="pallas", fuse=fuse, cache=JE.PlanCache())
        plan = TE.get_plan(shape=shape, levels=levels, scheme=scheme,
                           backend="cuda", fuse=fuse, device="cpu",
                           cache=TE.PlanCache())
        assert plan.launches == ref.pallas_calls
        assert plan.num_steps == ref.num_steps
        torch_plan = TE.get_plan(shape=shape, levels=levels, scheme=scheme,
                                 backend="torch", fuse=fuse, device="cpu",
                                 cache=TE.PlanCache())
        assert torch_plan.launches == 0


def test_main_path_launch_counts():
    """The chip script's main path: 8 x 2048 x 2048, 3 levels, cdf97."""
    kw = dict(shape=(8, 2048, 2048), levels=3, wavelet="cdf97",
              backend="cuda", device="cpu", cache=TE.PlanCache())
    assert TE.get_plan(scheme="ns-polyconv", fuse="none", **kw).launches == 6
    assert TE.get_plan(scheme="ns-polyconv", fuse="scheme",
                       **kw).launches == 3
    assert TE.get_plan(scheme="sep-lifting", fuse="none",
                       **kw).launches == 24


# ---------------------------------------------------------------------------
# errors: geometry text, devices, unported features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,levels", [(24, 40, 4), (30, 32, 2),
                                        (32, 18, 3)])
def test_geometry_error_text_identical(h, w, levels):
    with pytest.raises(ValueError) as ref:
        j_validate(h, w, levels)
    with pytest.raises(ValueError) as got:
        TE.validate_image_geometry(h, w, levels)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as via_api:
        R.dwt2(torch.zeros(h, w), levels=levels, device="cpu")
    assert str(via_api.value) == str(ref.value)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros(2, 16, 16)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        R.dwt2(x)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        R.idwt2(R.dwt2(x, device="cpu"))
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        TE.get_plan(shape=(16, 16))


def test_plan_key_without_device_does_not_plan_for_the_cpu(monkeypatch):
    """``PlanKey.device`` defaults to "cuda", like ``get_plan`` and
    ``dwt2``: with no card, building (directly or through a cache) raises
    and names device="cpu"; with one, "cuda" and "cuda:<n>" are one key."""
    key = TE.PlanKey(wavelet="cdf97", scheme="ns-polyconv", levels=1,
                     shape=(16, 16), dtype="float32", backend="cuda",
                     optimize=False, fuse="none", boundary="periodic")
    assert key.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        TE.build_plan(key)
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        TE.PlanCache().get(key)
    cpu = dataclasses.replace(key, device="cpu")
    assert TE.build_plan(cpu).key == cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert TE.canonical_key(key) == dataclasses.replace(key,
                                                        device="cuda:0")
    assert TE.canonical_key(TE.canonical_key(key)) == TE.canonical_key(key)


def test_plan_rejects_input_on_another_device():
    plan = TE.get_plan(shape=(16, 16), device="cpu", cache=TE.PlanCache())
    with pytest.raises(ValueError, match="built for shape"):
        plan.execute(torch.zeros(16, 32))
    with pytest.raises(ValueError, match="built for device cpu"):
        plan.execute(torch.zeros(16, 16, device="meta"))


@pytest.mark.parametrize("kw,field", [
    # a tiled plan keeps every backend check of its key
    (dict(tiles=(8, 8), backend="cuda", dtype="float64"), "PlanKey.dtype"),
    # the reference's XLA conv path is backend "conv" here
    (dict(backend="xla"), "'conv'"),
    # the reference's name of the "cuda" backend ("auto" is ported: it
    # builds, tests/test_torch_profiler.py)
    (dict(backend="pallas"), "PlanKey.backend"),
    (dict(backend="nope"), "PlanKey.backend"),
    (dict(backend="cuda", dtype="float64"), "PlanKey.dtype"),
])
def test_unported_features_raise_at_plan_build(kw, field):
    with pytest.raises(TE.BackendError) as err:
        TE.get_plan(shape=(2, 32, 32), device="cpu", cache=TE.PlanCache(),
                    **kw)
    assert field in str(err.value)
    assert "PlanKey." in str(err.value)


def test_tiled_plan_builds_and_reports_its_grid():
    """``PlanKey.tiles`` builds on every backend: the plan carries its
    grid and tile count, and launches what its window plan launches."""
    for backend, launches in (("torch", 0), ("cuda", 2), ("conv", 2)):
        plan = TE.get_plan(shape=(2, 32, 32), levels=1, tiles=(8, 8),
                           backend=backend, device="cpu",
                           cache=TE.PlanCache())
        assert plan.tile_count == 16 and plan.grid.grid_shape == (4, 4)
        assert plan.launches == launches
    mono = TE.get_plan(shape=(2, 32, 32), device="cpu",
                       cache=TE.PlanCache())
    assert mono.grid is None and mono.tile_count is None


def test_torch_backend_runs_pyramid_as_level_chain():
    x = torch.from_numpy(_image((2, 32, 32), seed=3))
    a = R.dwt2(x, levels=2, backend="torch", fuse="pyramid", device="cpu")
    b = R.dwt2(x, levels=2, backend="torch", fuse="none", device="cpu")
    for p, q in zip(_planes_np(a), _planes_np(b)):
        np.testing.assert_array_equal(p, q)


def test_validate_nan_rejects_non_finite():
    x = torch.zeros(2, 16, 16)
    x[1, 3, 4] = float("nan")
    with pytest.raises(ValueError, match="1 non-finite"):
        R.dwt2(x, validate="nan", device="cpu")
    pyr = R.dwt2(torch.zeros(16, 16), device="cpu")
    pyr.details[0][1][0, 0] = float("inf")
    with pytest.raises(ValueError, match="LH plane, level 0"):
        R.idwt2(pyr, validate="nan", device="cpu")
