"""The conv backend (``backend="conv"``, the reference's ``"xla"``) and the
single-level kernel entry (``repro_torch.kernels.ops`` and the five
per-scheme drivers), against the reference package on the CPU.

The conv backend is held to the reference's "jnp" backend (fp32 and fp16
I/O) and, under bf16 compute, to the reference's own conv backend, which
rounds the same composed filter bank; its ``F.conv2d`` calls are counted
against ``plan.launches``, and its convs run with cuDNN's TF32 off
whatever the global setting.  ``apply_scheme_cuda`` runs the window
kernel's plain version here, held to the reference's interpret-mode
``apply_scheme_pallas`` and to its "jnp" level.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro import compiler as JC
from repro.compiler import conv as JCV
from repro.core import transform as JT
from repro.core.schemes import SCHEMES
from repro.engine import cache as JE
from repro.kernels import ops as JOPS

import repro_torch as R
from repro_torch import compiler as TC
from repro_torch import engine as TE
from repro_torch.compiler import conv as CV
from repro_torch.kernels import ops as TOPS

# tests/test_differential.py ROUNDTRIP_TOL / CROSS_TOL
ROUNDTRIP_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
                 "float16": dict(rtol=2e-2, atol=2e-3)}
CROSS_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "float16": dict(rtol=2e-2, atol=2e-3)}
WAVELETS = ("cdf53", "cdf97", "dd137")
DRIVERS = {"sep-conv": "sep_conv", "sep-lifting": "sep_lifting",
           "ns-conv": "ns_conv", "ns-lifting": "ns_lifting",
           "ns-polyconv": "ns_polyconv"}


def _img(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _planes(pyr):
    return [pyr.ll] + [d for det in pyr.details for d in det]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def _assert_close(got, ref, tol):
    g, r = _planes(got), _planes(ref)
    assert [tuple(a.shape) for a in g] == [tuple(b.shape) for b in r]
    for a, b in zip(g, r):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---------------------------------------------------------------------------
# conv backend: parity, tiny planes, launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", ("none", "levels"))
@pytest.mark.parametrize("precision", ("fp32", "fp16-io", "bf16-compute"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_conv_dwt2_matches_reference(scheme, precision, fuse):
    io = np.float16 if precision == "fp16-io" else np.float32
    cdt = "bfloat16" if precision == "bf16-compute" else "float32"
    tol = CROSS_TOL["float32" if precision == "fp32" else "float16"]
    x = _img((2, 3 * 8, 5 * 8), seed=1, dtype=io)
    if cdt == "bfloat16":
        # the composed bank rounds to bf16 as the reference's conv does
        ref = JT.dwt2(x, levels=3, scheme=scheme, backend="xla", fuse=fuse,
                      compute_dtype=cdt)
    else:
        ref = JT.dwt2(x, levels=3, scheme=scheme, backend="jnp")
    kw = dict(scheme=scheme, backend="conv", fuse=fuse, compute_dtype=cdt,
              device="cpu")
    pyr = R.dwt2(torch.from_numpy(x), levels=3, **kw)
    assert pyr.ll.dtype == torch.from_numpy(x).dtype
    _assert_close(pyr, ref, tol)
    if cdt == "float32":
        np.testing.assert_allclose(
            _np(R.idwt2(pyr, **kw)), x.astype(np.float32),
            **ROUNDTRIP_TOL["float32" if io == np.float32 else "float16"])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_conv_plane_smaller_than_its_pad_radius(scheme):
    """(2, 4, 6) with dd137: 2x3 planes, no taller than the composed
    bank's pad radius, so the mod-indexed pre-pad wraps more than once
    (``F.pad(mode="circular")`` rejects this)."""
    x = _img((2, 4, 6), seed=2)
    plan = TE.get_plan(shape=x.shape, wavelet="dd137", scheme=scheme,
                       backend="conv", fuse="levels", device="cpu",
                       cache=TE.PlanCache())
    rn, rm = CV.lower_program_to_conv(plan.level_specs[0].fwd_programs[0]).pad
    assert rn > x.shape[-2] // 2 and rm >= x.shape[-1] // 2
    ref = JT.dwt2(x, wavelet="dd137", scheme=scheme, backend="jnp")
    for fuse in ("none", "levels"):
        kw = dict(wavelet="dd137", scheme=scheme, backend="conv", fuse=fuse,
                  device="cpu")
        pyr = R.dwt2(torch.from_numpy(x), **kw)
        _assert_close(pyr, ref, CROSS_TOL["float32"])
        np.testing.assert_allclose(R.idwt2(pyr, **kw).numpy(), x,
                                   **ROUNDTRIP_TOL["float32"])


def test_wrap_pad_is_periodic_at_any_radius():
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    got = CV._wrap_pad(x, 4, 7)
    rows = torch.arange(-4, 3 + 4) % 3
    cols = torch.arange(-7, 5 + 7) % 5
    assert torch.equal(got, x[:, rows][:, :, cols])
    assert torch.equal(CV._wrap_pad(x, 0, 0), x)


@pytest.mark.parametrize("fuse", ("none", "scheme", "levels"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_conv_launches_equal_counted_calls(scheme, fuse):
    shape = (2, 32, 32)
    plan = TE.get_plan(shape=shape, levels=3, scheme=scheme, backend="conv",
                       fuse=fuse, device="cpu", cache=TE.PlanCache())
    ref = JE.get_plan(shape=shape, levels=3, scheme=scheme, backend="xla",
                      fuse=fuse, cache=JE.PlanCache())
    assert plan.launches == ref.pallas_calls
    CV.CONV2D.launches = 0
    pyr = plan.execute(torch.from_numpy(_img(shape, seed=3)))
    assert CV.CONV2D.launches == plan.launches
    plan.execute_inverse(pyr)
    assert CV.CONV2D.launches == 2 * plan.launches


def test_conv_rejects_the_pyramid_fuse_mode():
    with pytest.raises(TE.BackendError, match=r"PlanKey\.fuse='pyramid'"):
        TE.get_plan(shape=(2, 16, 16), backend="conv", fuse="pyramid",
                    device="cpu", cache=TE.PlanCache())
    assert TE.get_backend("conv").fuse_modes == \
        JE.get_plan(shape=(16, 16), backend="xla").backend.fuse_modes


@pytest.mark.parametrize("fuse", ("none", "scheme"))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_conv_banks_and_stats_equal_reference(wavelet, scheme, fuse):
    for optimize, inverse in ((False, False), (True, False), (False, True)):
        ours = [CV.lower_program_to_conv(p) for p in
                TC.compile_scheme_programs(wavelet, scheme, optimize,
                                           inverse, "full", fuse)]
        theirs = [JCV.lower_program_to_conv(p) for p in
                  JC.compile_scheme_programs(wavelet, scheme, optimize,
                                             inverse, "full", fuse)]
        assert CV.conv_stats(ours) == JCV.conv_stats(theirs)
        for a, b in zip(ours, theirs):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.weights, b.weights)


# ---------------------------------------------------------------------------
# conv backend: full fp32 whatever cuDNN's global TF32 setting says
# ---------------------------------------------------------------------------

def _tf32_setting():
    conv = getattr(torch.backends.cudnn, "conv", None)
    return (torch.backends.cudnn.allow_tf32,
            getattr(conv, "fp32_precision", None))


def _conv_tf32():
    """What a cuDNN convolution reads: the per-operator precision where
    this PyTorch has it (the legacy flag then raises while the conv and
    RNN settings differ), else the legacy flag."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return conv.fp32_precision
    return torch.backends.cudnn.allow_tf32


def test_conv_pins_full_fp32_and_restores_the_setting(monkeypatch):
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(_conv_tf32())
        return real(*args, **kwargs)

    monkeypatch.setattr(CV.F, "conv2d", spy)
    before = _tf32_setting()
    x = torch.from_numpy(_img((2, 16, 16), seed=4))
    pyr = R.dwt2(x, levels=2, backend="conv", device="cpu")
    R.idwt2(pyr, backend="conv", device="cpu")
    assert _tf32_setting() == before
    assert len(seen) == 2 * 2 * 2        # 2 steps x 2 levels x 2 directions
    assert all(v in ("ieee", False) for v in seen)


def test_full_fp32_restores_after_an_error():
    before = _tf32_setting()
    with pytest.raises(RuntimeError):
        with CV.full_fp32():
            raise RuntimeError("conv failed")
    assert _tf32_setting() == before


# ---------------------------------------------------------------------------
# single-level entry: apply_scheme_cuda, the five drivers, scheme_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", ("none", "scheme"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_apply_scheme_matches_reference_jnp_level(scheme, fuse):
    x = _img((2, 14, 22), seed=5)
    ref = JT.dwt2(x, levels=1, scheme=scheme, backend="jnp")
    out = TOPS.apply_scheme_cuda(torch.from_numpy(x), scheme=scheme,
                                 fuse=fuse)
    for a, b in zip(out, [ref.ll, *ref.details[0]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **CROSS_TOL["float32"])
    rec = TOPS.apply_scheme_cuda(out, scheme=scheme, fuse=fuse,
                                 inverse=True)
    np.testing.assert_allclose(rec.numpy(), x, **ROUNDTRIP_TOL["float32"])
    # the engine's level 0 is the same launches on the same programs
    pyr = R.dwt2(torch.from_numpy(x), scheme=scheme, backend="cuda",
                 fuse=fuse, device="cpu")
    for a, b in zip(out, [pyr.ll, *pyr.details[0]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", sorted(DRIVERS))
def test_scheme_drivers_equal_apply_scheme(scheme):
    mod = importlib.import_module(f"repro_torch.kernels.{DRIVERS[scheme]}")
    assert mod.SCHEME == scheme
    x = torch.from_numpy(_img((3, 12, 20), seed=6))
    for optimize, fuse, tap_opt in itertools.product(
            (False, True), ("none", "levels"), ("off", "full")):
        got = mod.forward(x, "cdf97", optimize=optimize, fuse=fuse,
                          tap_opt=tap_opt)
        want = TOPS.apply_scheme_cuda(x, scheme=scheme, optimize=optimize,
                                      fuse=fuse, tap_opt=tap_opt)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_apply_scheme_matches_reference_pallas():
    """The reference's Pallas kernel in interpret mode, one configuration
    per direction, bf16 compute included."""
    x = _img((2, 24, 40), seed=7)
    for cdt, tol in (("float32", CROSS_TOL["float32"]),
                     ("bfloat16", CROSS_TOL["float16"])):
        ref = JOPS.apply_scheme_pallas(x, scheme="ns-polyconv",
                                       fuse="scheme", interpret=True,
                                       compute_dtype=cdt)
        out = TOPS.apply_scheme_cuda(torch.from_numpy(x),
                                     scheme="ns-polyconv", fuse="scheme",
                                     compute_dtype=cdt)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        planes = tuple(np.array(b) for b in ref)
        ref_inv = JOPS.apply_scheme_pallas(planes, scheme="ns-polyconv",
                                           fuse="scheme", inverse=True,
                                           interpret=True,
                                           compute_dtype=cdt)
        rec = TOPS.apply_scheme_cuda(
            tuple(torch.from_numpy(p) for p in planes), scheme="ns-polyconv",
            fuse="scheme", inverse=True, compute_dtype=cdt)
        np.testing.assert_allclose(rec.numpy(), np.asarray(ref_inv), **tol)


@pytest.mark.parametrize("tap_opt", ("off", "full"))
@pytest.mark.parametrize("fuse", ("none", "scheme", "levels", "pyramid"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_stats_equal_reference(scheme, fuse, tap_opt):
    for wavelet, optimize in (("cdf97", False), ("cdf97", True),
                              ("dd137", False)):
        ours = TOPS.scheme_stats(wavelet, scheme, optimize, (64, 96),
                                 fuse=fuse, tap_opt=tap_opt)
        theirs = JOPS.scheme_stats(wavelet, scheme, optimize, (64, 96),
                                   fuse=fuse, tap_opt=tap_opt)
        assert ours.pop("launches") == theirs.pop("pallas_calls")
        assert ours.pop("hbm_bytes") > 0 and theirs.pop("hbm_bytes") > 0
        assert ours == theirs


def test_apply_scheme_rejects_unknown_fuse():
    with pytest.raises(ValueError, match="unknown fuse mode"):
        TOPS.apply_scheme_cuda(torch.zeros(8, 8), fuse="tiles")
