"""The CUDA kernels on the card (the window kernel K1 and the
fused-pyramid kernels K2/K3), against their plain versions; the packet
and 3-D paths through K1 against the same calls on the CPU; and the
conv backend on the card at full fp32.

Marked ``cuda``: where no CUDA device is present every test skips with
that reason.  On a machine with the card (no JAX needed):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Whether a card is present is decided inside the ``cuda_device`` fixture,
never at import, so every process collects the same tests.
"""
import itertools

import pytest
import torch

import repro_torch as R
from repro_torch import compiler as C
from repro_torch.kernels import tap_window as TW

pytestmark = pytest.mark.cuda

WAVELETS = ("cdf53", "cdf97", "dd137")
SCHEMES = ("sep-conv", "sep-lifting", "sep-polyconv", "ns-conv",
           "ns-polyconv", "ns-lifting")
# tests/test_differential.py CROSS_TOL / ROUNDTRIP_TOL
CROSS_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "float16": dict(rtol=2e-2, atol=2e-3)}
ROUNDTRIP_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False); run on the card with: PYTHONPATH=src python -m "
                    "pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def _planes(shape, device, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device=device, dtype=dtype)
            for _ in range(4)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_kernel_equals_plain_version_bit_for_bit(cuda_device, wavelet,
                                                 scheme):
    planes = _planes((3, 37, 53), cuda_device)
    for optimize, inverse, fuse, opt in itertools.product(
            (False, True), (False, True), ("none", "scheme"),
            ("off", "exact", "full")):
        for prog in C.compile_scheme_programs(wavelet, scheme, optimize,
                                              inverse, opt, fuse):
            win = TW.encode(prog, TW.fit_block((prog,), 37, 53))
            got = TW.tap_window(win, planes)
            want = TW.tap_window_ref(win, planes)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (optimize, inverse, fuse, opt)


@pytest.mark.parametrize("io,cdt", [(torch.float16, "float32"),
                                    (torch.bfloat16, "float32"),
                                    (torch.float32, "bfloat16"),
                                    (torch.bfloat16, "bfloat16")])
def test_kernel_narrow_types_match_plain_version(cuda_device, io, cdt):
    planes = _planes((2, 24, 509), cuda_device, dtype=io)
    for fuse in ("none", "scheme"):
        for prog in C.compile_scheme_programs("cdf97", "ns-polyconv", False,
                                              False, "full", fuse):
            win = TW.encode(prog, TW.fit_block((prog,), 24, 509), cdt)
            got = TW.tap_window(win, planes)
            want = TW.tap_window_ref(win, planes)
            for g, w in zip(got, want):
                assert g.dtype == io
                torch.testing.assert_close(g.float(), w.float(),
                                           **CROSS_TOL["float16"])


@pytest.mark.parametrize("scheme,fuse", [("ns-polyconv", "none"),
                                         ("ns-polyconv", "scheme"),
                                         ("sep-lifting", "none")])
def test_dwt2_counts_launches_and_matches_torch_backend(cuda_device, scheme,
                                                        fuse):
    x = torch.randn(4, 96, 160, generator=torch.Generator().manual_seed(1)
                    ).to(cuda_device)
    kw = dict(levels=3, scheme=scheme, fuse=fuse, device=cuda_device)
    plan = R.get_plan(shape=tuple(x.shape), backend="cuda", **kw)
    before = TW.KERNEL.launches
    pyr = R.dwt2(x, backend="cuda", **kw)
    assert TW.KERNEL.launches - before == plan.launches
    ref = R.dwt2(x, backend="torch", **kw)
    for p, q in zip([pyr.ll, *[d for det in pyr.details for d in det]],
                    [ref.ll, *[d for det in ref.details for d in det]]):
        torch.testing.assert_close(p, q, **CROSS_TOL["float32"])
    rec = R.idwt2(pyr, backend="cuda", scheme=scheme, fuse=fuse,
                  device=cuda_device)
    assert TW.KERNEL.launches - before == 2 * plan.launches
    torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 24, 509)])
def test_persistent_grid_equals_plain_version(cuda_device, shape):
    """The persistent grid (at most the resident blocks, each looping
    over tiles) at ragged shapes and at a block small enough that every
    block walks several tiles."""
    planes = _planes(shape, cuda_device, seed=5)
    for scheme, fuse in (("ns-polyconv", "scheme"), ("ns-polyconv", "none"),
                         ("sep-lifting", "none"), ("dd137", "scheme")):
        wavelet = "dd137" if scheme == "dd137" else "cdf97"
        scheme = "ns-conv" if scheme == "dd137" else scheme
        for prog in C.compile_scheme_programs(wavelet, scheme, False, False,
                                              "full", fuse):
            for block in (TW.fit_block((prog,), *shape[1:]), (8, 8)):
                win = TW.encode(prog, block)
                got = TW.tap_window(win, planes)
                grid, per_sm = TW.KERNEL.last_grid
                assert 1 <= grid <= win.tiles(shape) and per_sm >= 1
                want = TW.tap_window_ref(win, planes)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (scheme, fuse, block)


def test_wrapper_rejects_non_contiguous_planes(cuda_device):
    prog = C.compile_scheme_programs("cdf53", "ns-conv", False, False,
                                     "full", "none")[0]
    win = TW.encode(prog, (8, 8))
    planes = [p.transpose(1, 2) for p in _planes((1, 16, 8), cuda_device)]
    with pytest.raises(ValueError, match="contiguous"):
        TW.tap_window(win, planes)


# ---------------------------------------------------------------------------
# the fused-pyramid kernels K2 / K3
# ---------------------------------------------------------------------------

def _pyramid_kernels(wavelet, scheme, levels, shape, compute="float32"):
    """K2/K3 encoded at the block the plan's guard picks for ``shape``
    (None where the configuration falls back to fuse="levels")."""
    spec = R.get_plan(wavelet=wavelet, scheme=scheme, levels=levels,
                      shape=shape, backend="cuda", fuse="pyramid",
                      compute_dtype=compute, device="cpu",
                      cache=R.PlanCache()).pyramid
    return None if spec is None else (spec.fwd_kernel, spec.inv_kernel)


@pytest.mark.parametrize("levels", (1, 2, 3))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_pyramid_kernels_equal_plain_versions(cuda_device, scheme, levels):
    from repro_torch.kernels import pyramid_window as PW
    g = torch.Generator().manual_seed(levels)
    for wavelet, shape in itertools.product(WAVELETS, [(3, 296, 424),
                                                       (2, 256, 4072)]):
        kernels = _pyramid_kernels(wavelet, scheme, levels, shape)
        if kernels is None:
            continue          # falls back to fuse="levels": no kernel
        fwd, inv = kernels
        x = torch.randn(shape, generator=g).to(cuda_device)
        ll, det = PW.pyramid_forward(fwd, x)
        rll, rdet = PW.pyramid_forward_ref(fwd, x)
        for a, b in zip([ll] + [d for t in det for d in t],
                        [rll] + [d for t in rdet for d in t]):
            assert torch.equal(a, b), (wavelet, shape)
        rec = PW.pyramid_inverse(inv, ll, det)
        assert torch.equal(rec, PW.pyramid_inverse_ref(inv, ll, det))
        torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)


@pytest.mark.parametrize("io,cdt", [(torch.float16, "float32"),
                                    (torch.bfloat16, "float32"),
                                    (torch.float32, "bfloat16"),
                                    (torch.bfloat16, "bfloat16")])
def test_pyramid_kernels_narrow_types_equal_plain_versions(cuda_device, io,
                                                           cdt):
    from repro_torch.kernels import pyramid_window as PW
    fwd, inv = _pyramid_kernels("cdf97", "ns-polyconv", 3, (2, 256, 4072),
                                compute=cdt)
    x = torch.randn((2, 256, 4072), generator=torch.Generator()
                    .manual_seed(3)).to(cuda_device, io)
    ll, det = PW.pyramid_forward(fwd, x)
    rll, rdet = PW.pyramid_forward_ref(fwd, x)
    for a, b in zip([ll] + [d for t in det for d in t],
                    [rll] + [d for t in rdet for d in t]):
        assert a.dtype == io and torch.equal(a, b)
    assert torch.equal(PW.pyramid_inverse(inv, ll, det),
                       PW.pyramid_inverse_ref(inv, ll, det))


@pytest.mark.parametrize("scheme", ("ns-polyconv", "sep-lifting"))
def test_pyramid_is_one_launch_and_equals_levels(cuda_device, scheme):
    from repro_torch.kernels import pyramid_window as PW
    x = torch.randn(4, 96, 160, generator=torch.Generator().manual_seed(2)
                    ).to(cuda_device)
    kw = dict(levels=3, scheme=scheme, device=cuda_device)
    plan = R.get_plan(shape=tuple(x.shape), backend="cuda", fuse="pyramid",
                      **kw)
    assert plan.pyramid is not None and plan.launches == 1
    before = (PW.FORWARD.launches, PW.INVERSE.launches, TW.KERNEL.launches)
    pyr = R.dwt2(x, fuse="pyramid", **kw)
    rec = R.idwt2(pyr, fuse="pyramid", scheme=scheme, device=cuda_device)
    torch.cuda.synchronize()
    assert (PW.FORWARD.launches, PW.INVERSE.launches, TW.KERNEL.launches) \
        == (before[0] + 1, before[1] + 1, before[2])
    lvl = R.dwt2(x, fuse="levels", **kw)
    for a, b in zip([pyr.ll, *[d for det in pyr.details for d in det]],
                    [lvl.ll, *[d for det in lvl.details for d in det]]):
        assert torch.equal(a, b)
    assert torch.equal(rec, R.idwt2(pyr, fuse="levels", scheme=scheme,
                                    device=cuda_device))
    torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)


def test_cooperative_pyramid_on_a_ragged_image(cuda_device):
    """K2's and K3's cooperative launches (every block resident, a
    grid-wide barrier between levels) at 3 levels on 2 x 256 x 4072, whose
    level planes are ragged against the tiles; their grids fit the card at
    once, and both equal their plain versions bit for bit."""
    from repro_torch.kernels import pyramid_window as PW
    fwd, inv = _pyramid_kernels("cdf97", "ns-polyconv", 3, (2, 256, 4072))
    x = torch.randn((2, 256, 4072), generator=torch.Generator()
                    .manual_seed(4)).to(cuda_device)
    ll, det = PW.pyramid_forward(fwd, x)
    grid, per_sm = PW.FORWARD.last_grid
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert 1 <= grid <= per_sm * sms
    assert grid <= max(fwd.level_tiles(tuple(x.shape)))
    rll, rdet = PW.pyramid_forward_ref(fwd, x)
    for a, b in zip([ll] + [d for t in det for d in t],
                    [rll] + [d for t in rdet for d in t]):
        assert torch.equal(a, b)
    assert torch.equal(PW.pyramid_inverse(inv, ll, det),
                       PW.pyramid_inverse_ref(inv, ll, det))
    grid, per_sm = PW.INVERSE.last_grid
    assert 1 <= grid <= min(per_sm * sms,
                            max(inv.level_tiles(tuple(x.shape))))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_seven_level_pyramid_kernels_equal_plain_versions(cuda_device,
                                                          scheme):
    """Seven levels on 2 x 256 x 384: the coarsest planes (2x3) are far
    smaller than a tile, so every window wraps; K2 and K3 equal their
    plain versions bit for bit and round-trip."""
    from repro_torch.kernels import pyramid_window as PW
    fwd, inv = _pyramid_kernels("cdf97", scheme, 7, (2, 256, 384))
    x = torch.randn((2, 256, 384), generator=torch.Generator()
                    .manual_seed(5)).to(cuda_device)
    ll, det = PW.pyramid_forward(fwd, x)
    rll, rdet = PW.pyramid_forward_ref(fwd, x)
    for a, b in zip([ll] + [d for t in det for d in t],
                    [rll] + [d for t in rdet for d in t]):
        assert torch.equal(a, b)
    rec = PW.pyramid_inverse(inv, ll, det)
    assert torch.equal(rec, PW.pyramid_inverse_ref(inv, ll, det))
    torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)


def test_inverse_pyramid_refuses_a_launch_it_cannot_make_cooperative(
        cuda_device):
    """A K3 launch whose blocks cannot all be resident (here: more shared
    memory than a block may have) raises, names the kernel and runs
    nothing: no quiet fallback to another kernel or the plain version."""
    import dataclasses
    from repro_torch.kernels import pyramid_window as PW
    fwd, inv = _pyramid_kernels("cdf97", "ns-polyconv", 3, (2, 64, 64))
    x = torch.randn((2, 64, 64), generator=torch.Generator()
                    .manual_seed(6)).to(cuda_device)
    ll, det = PW.pyramid_forward(fwd, x)
    too_big = dataclasses.replace(inv, smem_bytes=TW.SMEM_LIMIT + 1024)
    before = PW.INVERSE.launches
    with pytest.raises(RuntimeError,
                       match="pyramid_inverse launch failed.*cooperative"):
        PW.pyramid_inverse(too_big, ll, det)
    assert PW.INVERSE.launches == before
    assert torch.equal(PW.pyramid_inverse(inv, ll, det),
                       PW.pyramid_inverse_ref(inv, ll, det))


@pytest.mark.parametrize("fuse", ("none", "levels"))
def test_workloads_on_the_card_equal_the_cpu_bit_for_bit(cuda_device, fuse):
    """wpt2/iwpt2 and dwt3/idwt3 through K1 equal the same calls on
    device="cpu" (the kernel's plain version) bit for bit in fp32, and
    launch K1 exactly ``plan.launches`` times per transform."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 40, 56), generator=g)
    v = torch.randn((2, 8, 24, 40), generator=g)
    mixed = ("aa", "ah", "av", "ad", "h", "v", "da", "dh", "dv", "dd")
    for packet in ("full:2", mixed):
        kw = dict(packet=packet, fuse=fuse, backend="cuda")
        plan = R.get_plan(shape=tuple(x.shape), device=cuda_device, **kw)
        before = TW.KERNEL.launches
        got = R.wpt2(x, device=cuda_device, **kw)
        torch.cuda.synchronize()
        assert TW.KERNEL.launches == before + plan.launches
        want = R.wpt2(x, device="cpu", **kw)
        for a, b in zip(got.leaves, want.leaves):
            assert torch.equal(a.cpu(), b)
        rec = R.iwpt2(got, fuse=fuse, backend="cuda", device=cuda_device)
        assert torch.equal(rec.cpu(), R.iwpt2(want, fuse=fuse,
                                              backend="cuda", device="cpu"))
    kw = dict(levels=2, fuse=fuse, backend="cuda")
    plan = R.get_plan(shape=tuple(v.shape), ndim=3, device=cuda_device, **kw)
    before = TW.KERNEL.launches
    got = R.dwt3(v, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert TW.KERNEL.launches == before + plan.launches
    want = R.dwt3(v, device="cpu", **kw)
    for a, b in zip([got.ll, *[d for det in got.details for d in det]],
                    [want.ll, *[d for det in want.details for d in det]]):
        assert torch.equal(a.cpu(), b)
    rec = R.idwt3(got, fuse=fuse, backend="cuda", device=cuda_device)
    assert torch.equal(rec.cpu(), R.idwt3(want, fuse=fuse, backend="cuda",
                                          device="cpu"))
    torch.testing.assert_close(rec.cpu(), v, **ROUNDTRIP_TOL)


@pytest.mark.parametrize("scheme,fuse", [("ns-polyconv", "none"),
                                         ("ns-polyconv", "levels"),
                                         ("sep-lifting", "none")])
def test_conv_backend_runs_full_fp32_whatever_the_tf32_flag(cuda_device,
                                                            scheme, fuse):
    """With cuDNN's TF32 allowed globally (PyTorch's default), the conv
    backend still agrees with the torch backend to the fp32 bound, and
    leaves the setting as it found it."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)

    def setting():
        return cudnn.allow_tf32, getattr(conv, "fp32_precision", None)

    old = setting()
    cudnn.allow_tf32 = True
    try:
        before = setting()
        x = torch.randn((4, 256, 384), generator=torch.Generator()
                        .manual_seed(8)).to(cuda_device)
        kw = dict(scheme=scheme, fuse=fuse, device=cuda_device)
        pyr = R.dwt2(x, levels=3, backend="conv", **kw)
        ref = R.dwt2(x, levels=3, backend="torch", **kw)
        for a, b in zip([pyr.ll, *[d for det in pyr.details for d in det]],
                        [ref.ll, *[d for det in ref.details for d in det]]):
            torch.testing.assert_close(a, b, **CROSS_TOL["float32"])
        rec = R.idwt2(pyr, backend="conv", **kw)
        torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)
        assert setting() == before
    finally:
        cudnn.allow_tf32 = old[0]
