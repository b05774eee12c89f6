"""The CUDA kernels on the card (the window kernel K1, the fused-pyramid
kernels K2/K3, the temporal lifting kernel and the reversible lifting
kernel), against their plain versions; the packet and 3-D paths through K1 against the same calls on
the CPU; the conv backend on the card at full fp32; and
``backend="auto"`` and the server
on the card (cold rule, warmed store, served results bit for bit, two
workers on their own streams, pinned host buffers); gradient compression
through K1 (bit for bit against the plain version at qwen2-0.5b's tile
shapes), one compressed train step of qwen2-0.5b at full width and one
of each MoE, RWKV6, hybrid and whisper SMOKE config.

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


def _outputs(out):
    """A K1 call's outputs as a tuple: its four planes, or its image."""
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


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
# K1 reading a level's image and writing it back (split and merge folded)
# ---------------------------------------------------------------------------

def _fold_worst(x, levels, fuse, device, compute_dtype="float32"):
    """Largest |diff| of ``levels`` levels of ``x`` through K1 in the
    image layout (the engine's path: the first forward launch reads the
    image, the last inverse launch writes it) against the plane layout
    (planes copied contiguous, the output interleaved by ``from_planes``)
    and against the plain version, each level on the LL before it."""
    from repro_torch.core import schemes as S
    from repro_torch.kernels import polyphase as PP
    plan = R.get_plan(shape=tuple(x.shape), levels=levels,
                      scheme="ns-polyconv", fuse=fuse, backend="cuda",
                      dtype=str(x.dtype).split(".")[-1],
                      compute_dtype=compute_dtype, device=device)

    def chain(run, planes, windows):
        for win in windows:
            planes = run(win, planes)
        return planes

    worst = 0.0
    for spec in plan.level_specs:
        got = PP.apply_steps_cuda(spec.fwd_steps, x,
                                  windows=spec.fwd_windows)
        flat = [g.reshape((-1,) + g.shape[-2:]) for g in got]
        back = PP.apply_steps_cuda(spec.inv_steps, got,
                                   windows=spec.inv_windows, image_out=True)
        assert back.shape == x.shape
        for run in (TW.tap_window, TW.tap_window_ref):
            split = [p.reshape((-1,) + p.shape[-2:]).contiguous()
                     for p in S.to_planes(x)]
            want = chain(run, split, spec.fwd_windows)
            merged = S.from_planes(chain(run, flat, spec.inv_windows))
            worst = max([worst, float((back.reshape(merged.shape)
                                       - merged).abs().max())]
                        + [float((a - b).abs().max())
                           for a, b in zip(flat, want)])
        x = got[0]
    return worst


@pytest.mark.parametrize("case", ["slice2d", "vol3d-half-band", "ragged"])
def test_image_layouts_equal_plane_layout_and_plain_version(cuda_device,
                                                            case):
    """The image gather and the interleave sink at the K1 cells' shapes:
    the slice cell's request (932x512x512, 5 levels), one temporal
    half-band of the volume cell's (1864x512x512 through the temporal
    lifting kernel, 3 levels), and a ragged image at 2 levels: max
    |diff| 0.0 against the plane layout and the plain version."""
    from repro_torch.compiler import temporal as TP
    from repro_torch.kernels import temporal_lift as TL
    g = torch.Generator(device=cuda_device).manual_seed(7)
    if case == "slice2d":
        x, levels = torch.randn(932, 512, 512, generator=g,
                                device=cuda_device), 5
    elif case == "vol3d-half-band":
        vol = torch.randn(1864, 512, 512, generator=g, device=cuda_device)
        x, _ = TL.temporal_lift_forward(vol, TP.compile_temporal("cdf97"))
        del vol
        levels = 3
    else:
        x, levels = torch.randn(3, 148, 212, generator=g,
                                device=cuda_device), 2
    for fuse in ("none", "scheme"):
        assert _fold_worst(x, levels, fuse, cuda_device) == 0.0, fuse


@pytest.mark.parametrize("io,cdt", [(torch.float16, "float32"),
                                    (torch.bfloat16, "float32"),
                                    (torch.float32, "bfloat16"),
                                    (torch.bfloat16, "bfloat16")])
def test_image_layouts_narrow_types_and_wrap(cuda_device, io, cdt):
    """16-bit I/O and bfloat16 compute, batch dims and planes narrower
    than the halo (the wrap): the image layouts equal the plane layout
    and the plain version bit for bit."""
    g = torch.Generator().manual_seed(8)
    for shape, levels in (((2, 6, 40), 1), ((2, 3, 8, 12), 2),
                          ((2, 6, 10), 1)):
        x = torch.randn(shape, generator=g).to(cuda_device, io)
        for fuse in ("none", "scheme"):
            assert _fold_worst(x, levels, fuse, cuda_device, cdt) == 0.0


def test_image_layout_counts_folds_and_no_copies(cuda_device):
    """One slice-cell-shaped request through dwt2/idwt2 at fuse "none":
    a fold per level each way, no plane-copy bytes, 4 K1 launches a
    level; a non-contiguous image is copied once and counted."""
    from repro_torch.kernels import polyphase as PP
    x = torch.randn(6, 64, 96, device=cuda_device)
    kw = dict(scheme="ns-polyconv", fuse="none", backend="cuda",
              device=cuda_device)
    n0 = TW.KERNEL.launches
    f0 = {op: PP.PLANE_FOLDS.value(op=op) for op in ("split", "merge")}
    b0 = {op: PP.PLANE_COPY_BYTES.value(op=op) for op in ("split", "merge")}
    back = R.idwt2(R.dwt2(x, levels=3, **kw), **kw)
    torch.testing.assert_close(back, x, **ROUNDTRIP_TOL)
    assert TW.KERNEL.launches - n0 == 12
    for op in ("split", "merge"):
        assert PP.PLANE_FOLDS.value(op=op) - f0[op] == 3
        assert PP.PLANE_COPY_BYTES.value(op=op) == b0[op]
    xt = x.transpose(-1, -2)
    pyr = R.dwt2(xt, levels=1, **kw)
    assert PP.PLANE_COPY_BYTES.value(op="split") - b0["split"] == \
        xt.numel() * 4
    ref = R.dwt2(xt.contiguous(), levels=1, **kw)
    assert torch.equal(pyr.ll, ref.ll)


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


#: (I/O dtype, compute dtype) pairs the temporal lifting kernel is held to
TEMPORAL_DTYPES = ((torch.float32, torch.float32),
                   (torch.float16, torch.float32),
                   (torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.bfloat16))
#: T of 2, 4, 466 and 1864 frames; W not a multiple of 4; batch dims
TEMPORAL_SHAPES = ((2, 5, 7), (3, 4, 6, 10), (466, 9, 13), (2, 1864, 3, 7))


@pytest.mark.parametrize("io,cdt", TEMPORAL_DTYPES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_temporal_lift_equals_the_plain_pass(cuda_device, tmp_path, wavelet,
                                             io, cdt):
    """The temporal lifting kernel equals the plain pass bit for bit in
    every dtype, on contiguous volumes, on a strided view along T and on
    layouts it takes through a contiguous copy (a transposed plane, one
    channel of a channels-last video, transposed bands), one launch each;
    the "cuda" backend's temporal hooks launch it and no other kernel; a
    dwt3 + idwt3 round trip launches it 2 x levels times, and on a
    transposed volume equals the CPU's."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.compiler import temporal as TP
    from repro_torch.engine import backends as B
    from repro_torch.kernels import temporal_lift as TL
    fwd, inv = (TP.compile_temporal(wavelet, i) for i in (False, True))
    g = torch.Generator().manual_seed(3)
    vols = [torch.randn(s, generator=g) for s in TEMPORAL_SHAPES]
    vols.append(torch.randn((2, 932, 9, 13), generator=g)[:, 1::2])
    for v in vols:
        for x in (v.to(device=cuda_device, dtype=io),
                  v.to(device=cuda_device, dtype=io).transpose(-1, -2),
                  torch.stack([v, -v], -1).to(device=cuda_device,
                                              dtype=io)[..., 0]):
            before = TL.KERNEL.launches
            lo, hi = TL.temporal_lift_forward(x, fwd, cdt)
            back = TL.temporal_lift_inverse(lo, hi, inv, cdt)
            mt = TL.temporal_lift_inverse(lo.mT, hi.mT, inv, cdt)
            torch.cuda.synchronize()
            assert TL.KERNEL.launches == before + 3
            want = TP.temporal_forward(x, fwd, cdt)
            assert lo.dtype == io and lo.shape == want[0].shape
            assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
            assert torch.equal(back, TP.temporal_inverse(lo, hi, inv, cdt))
            assert torch.equal(mt, TP.temporal_inverse(lo.mT, hi.mT, inv,
                                                       cdt))
    be = B.get_backend("cuda")
    x = vols[1].to(device=cuda_device, dtype=io)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        be.temporal_inverse(*be.temporal_forward(x, fwd, cdt), inv, cdt)
        torch.cuda.synchronize()
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "kernel"}
    assert names and all("temporal_lift_kernel" in n for n in names), names
    v = torch.randn((2, 16, 24, 40), generator=g).to(device=cuda_device,
                                                     dtype=io)
    kw = dict(wavelet=wavelet, backend="cuda", device=cuda_device,
              compute_dtype=str(cdt).split(".")[-1])
    before = TL.KERNEL.launches
    got = R.dwt3(v, levels=3, **kw)
    rec = R.idwt3(got, **kw)
    torch.cuda.synchronize()
    assert TL.KERNEL.launches == before + 2 * 3
    want = R.dwt3(v.cpu(), levels=3, **{**kw, "device": "cpu"})
    assert torch.equal(got.ll.cpu(), want.ll)
    assert torch.equal(rec.cpu(), R.idwt3(want, **{**kw, "device": "cpu"}))
    got = R.dwt3(v.mT, levels=3, **kw)
    want = R.dwt3(v.mT.cpu(), levels=3, **{**kw, "device": "cpu"})
    assert torch.equal(got.ll.cpu(), want.ll)
    assert torch.equal(R.idwt3(got, **kw).cpu(),
                       R.idwt3(want, **{**kw, "device": "cpu"}))


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


# -- telemetry and the fault plane on the card --------------------------

@pytest.fixture
def port_planes():
    """The port's telemetry and fault planes at their defaults (counters,
    disarmed) around a test, restored after (the card runs these tests
    without conftest)."""
    from repro_torch import telemetry as T
    from repro_torch.faults import inject as FJ
    prev_mode, prev_plan = T.mode(), FJ.activate(None)
    T.set_mode("counters")
    T.reset()
    yield T
    FJ.activate(prev_plan)
    T.set_mode(prev_mode)
    T.reset()


@pytest.mark.parametrize("fuse", ("pyramid", "levels"))
def test_spans_give_device_time(cuda_device, port_planes, fuse):
    """A span around device work is timed on the card: it holds the
    CUDA-event time of the launch it wraps, and the execute span holds
    its children."""
    T = port_planes
    x = torch.randn(4, 512, 512, device=cuda_device)
    R.dwt2(x, levels=3, fuse=fuse, device=cuda_device)      # warm up
    T.set_mode("spans")
    with T.device_span("outer", cuda_device) as sp:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        R.dwt2(x, levels=3, fuse=fuse, device=cuda_device)
        e1.record()
    e1.synchronize()
    inner = e0.elapsed_time(e1) / 1e3
    assert sp.duration >= inner > 0
    recs = T.TRACER.records()
    (ex,) = [r for r in recs if r.name == "execute.forward"]
    kids = [r for r in recs if r.parent_id == ex.span_id]
    assert ex.clock == "cuda" and all(k.clock == "cuda" for k in kids)
    assert [k.name for k in kids] == (["pyramid.launch"] if fuse == "pyramid"
                                      else ["level.forward"] * 3)
    assert sp.duration >= ex.dur_s >= max(k.dur_s for k in kids) > 0


def test_pyramid_launch_fault_degrades_to_levels_on_the_card(cuda_device,
                                                            port_planes):
    from repro_torch.faults import degrade as DG
    from repro_torch.faults import inject as FJ
    from repro_torch.faults import plan as FP
    from repro_torch.kernels import pyramid_window as PW
    x = torch.randn(2, 256, 256, device=cuda_device)
    want = R.dwt2(x, levels=3, fuse="levels", device=cuda_device)
    R.dwt2(x, levels=3, fuse="pyramid", device=cuda_device)   # plan built
    FJ.activate(FP.FaultPlan.from_text("pyramid.launch=raise:always"))
    n_k1, n_k2 = TW.KERNEL.launches, PW.FORWARD.launches
    got = R.dwt2(x, levels=3, fuse="pyramid", device=cuda_device)
    torch.cuda.synchronize()
    FJ.activate(None)
    assert TW.KERNEL.launches - n_k1 == 3
    assert PW.FORWARD.launches == n_k2
    for g, w in zip([got.ll] + [d for t in got.details for d in t],
                    [want.ll] + [d for t in want.details for d in t]):
        assert torch.equal(g, w)
    assert DG.FALLBACKS.value(**{"from": "cuda/pyramid",
                                 "to": "cuda/levels",
                                 "site": "pyramid.launch"}) == 1


def test_counters_mode_adds_no_synchronisation(cuda_device, port_planes):
    T = port_planes
    x = torch.randn(2, 256, 256, device=cuda_device)

    def run():
        for fuse in ("pyramid", "none"):
            pyr = R.dwt2(x, levels=3, fuse=fuse, device=cuda_device)
            R.idwt2(pyr, fuse=fuse, device=cuda_device)

    run()                               # plans built, tables uploaded
    torch.cuda.synchronize()
    assert len(T.synchronising_calls(lambda: float(x[0, 0, 0]))) >= 1
    counts = {}
    for mode in ("off", "counters", "off", "counters"):
        T.set_mode(mode)
        counts.setdefault(mode, []).append(
            len(T.synchronising_calls(run)))
    assert counts["counters"] == counts["off"], counts


def test_spans_mode_waits_for_the_card_only_when_read(cuda_device,
                                                      port_planes):
    """Spans record CUDA events and resolve them when read: executing in
    spans mode adds no synchronisation, and the roofline read after it
    divides by device time (at most the card's 3.35 TB/s)."""
    T = port_planes
    x = torch.randn(8, 512, 512, device=cuda_device)

    def run():
        for fuse in ("pyramid", "levels"):
            pyr = R.dwt2(x, levels=3, fuse=fuse, device=cuda_device)
            R.idwt2(pyr, fuse=fuse, device=cuda_device)

    run()
    torch.cuda.synchronize()
    counts = {}
    for mode in ("off", "spans", "off", "spans"):
        T.set_mode(mode)
        counts.setdefault(mode, []).append(
            len(T.synchronising_calls(run)))
    assert counts["spans"] == counts["off"], counts
    rows = T.roofline()
    assert {(r["fuse"], r["op"]) for r in rows} == {
        (f, op) for f in ("pyramid", "levels")
        for op in ("forward", "inverse")}
    assert all(0 < r["gbps"] <= 3350 for r in rows), rows


# -- tiling and streaming on the card ------------------------------------

def _all_planes(pyr):
    return [pyr.ll] + [d for det in pyr.details for d in det]


@pytest.mark.parametrize("fuse,k1,k2", [("none", 4, 0), ("levels", 2, 0),
                                        ("pyramid", 0, 1)])
def test_tiled_equals_monolithic_with_exact_launches(cuda_device, fuse, k1,
                                                     k2):
    """Tiled dwt2/idwt2 on "cuda" (non-dividing 96x96 tiles of a 2x256x320
    batch) equals the monolithic transform bit for bit, one batched
    window execution: K1 twice per level at "none", once at "levels", one
    K2 (K3) at "pyramid"."""
    from repro_torch.kernels import pyramid_window as PW
    x = torch.randn(2, 256, 320, generator=torch.Generator().manual_seed(5)
                    ).to(cuda_device)
    kw = dict(levels=2, fuse=fuse, backend="cuda", device=cuda_device)
    plan = R.get_plan(shape=tuple(x.shape), tiles=(96, 96), **kw)
    assert plan.launches == k1 + k2
    mono = R.dwt2(x, **kw)
    n = (TW.KERNEL.launches, PW.FORWARD.launches, PW.INVERSE.launches)
    tiled = R.dwt2(x, tiles=(96, 96), **kw)
    torch.cuda.synchronize()
    assert (TW.KERNEL.launches - n[0], PW.FORWARD.launches - n[1]) == (k1, k2)
    for p, q in zip(_all_planes(mono), _all_planes(tiled)):
        assert torch.equal(p, q)
    ikw = {k: v for k, v in kw.items() if k != "levels"}
    n = (TW.KERNEL.launches, PW.INVERSE.launches)
    rec = R.idwt2(mono, tiles=(96, 96), **ikw)
    torch.cuda.synchronize()
    assert (TW.KERNEL.launches - n[0], PW.INVERSE.launches - n[1]) == (k1, k2)
    assert torch.equal(rec, R.idwt2(mono, **ikw))
    torch.testing.assert_close(rec, x, **ROUNDTRIP_TOL)


def test_stream_staging_buffers_are_pinned(cuda_device):
    import numpy as np
    from repro_torch import engine as E
    img = np.random.default_rng(6).standard_normal((512, 512)).astype(
        np.float32)
    R.stream_dwt2(img, levels=2, tiles=(128, 128), device=cuda_device)
    plan = E.get_plan(shape=(512, 512), levels=2, tiles=(128, 128),
                      fuse="levels", device=cuda_device)
    slots = plan._stream_slots
    assert len(slots) == 3                      # max_inflight + 1
    for s in slots:
        assert s.stage.is_pinned()
        assert all(o.is_pinned() for o in s.out)


def test_stream_equals_monolithic(cuda_device):
    import numpy as np
    img = np.random.default_rng(7).standard_normal((2048, 2048)).astype(
        np.float32)
    for fuse in ("none", "levels"):
        pyr = R.stream_dwt2(img, levels=3, tiles=(512, 512), fuse=fuse,
                            device=cuda_device)
        mono = R.dwt2(torch.from_numpy(img), levels=3, fuse=fuse,
                      device=cuda_device)
        for p, q in zip(_all_planes(mono), _all_planes(pyr)):
            assert np.array_equal(p.cpu().numpy(), q)


# -- the profiler, backend="auto" and serving on the card ---------------

@pytest.fixture
def auto_files(tmp_path, monkeypatch, port_planes):
    """The profiler store and block table in ``tmp_path`` and an empty
    plan cache around a test."""
    from repro_torch import engine as E
    from repro_torch.engine import autotune as AT
    from repro_torch.serve import metrics as SM
    monkeypatch.setenv("REPRO_TORCH_PROFILE_STORE",
                       str(tmp_path / "store.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_BLOCK_TABLE",
                       str(tmp_path / "table.json"))
    AT.clear_cache()
    E.clear_plan_cache()
    SM.reset()
    yield tmp_path
    E.clear_plan_cache()
    AT.clear_cache()


def _images_np(n, h, w, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, w)).astype(np.float32) for _ in range(n)]


def test_auto_cold_resolves_to_cuda_pyramid(cuda_device, auto_files):
    from repro_torch import engine as E
    from repro_torch.kernels import pyramid_window as PW
    plan = E.get_plan(shape=(2, 256, 256), levels=3, backend="auto",
                      device=cuda_device)
    assert plan.auto.source == "heuristic"
    assert (plan.key.backend, plan.key.fuse) == ("cuda", "pyramid")
    assert plan.pyramid is not None
    x = torch.randn(2, 256, 256, device=cuda_device)
    n = PW.FORWARD.launches
    pyr = R.dwt2(x, levels=3, backend="auto", device=cuda_device)
    assert PW.FORWARD.launches == n + 1
    want = R.dwt2(x, levels=3, backend="cuda", fuse="pyramid",
                  device=cuda_device)
    assert torch.equal(pyr.ll, want.ll)
    one = E.get_plan(shape=(2, 256, 256), levels=1, backend="auto",
                     device=cuda_device)
    assert (one.key.backend, one.key.fuse) == ("cuda", "levels")


def test_auto_resolves_from_a_warmed_store_on_the_card(cuda_device,
                                                       auto_files):
    from repro_torch import engine as E
    from repro_torch import profiler as PF
    from repro_torch.kernels import tap_window as TW
    recs = PF.warm_store(shape=(2, 256, 256), levels=2, reps=3,
                         device=cuda_device)
    fp = "cuda:" + torch.cuda.get_device_name(0)
    assert all(r.fingerprint == fp and not r.meta["plain_kernels"]
               for r in recs)
    assert {(r.backend, r.fuse) for r in recs} >= {
        ("cuda", f) for f in ("none", "scheme", "levels", "pyramid")}
    best = min(recs, key=lambda r: (r.time_s, r.backend, r.fuse))
    plan = E.get_plan(shape=(2, 256, 256), levels=2, backend="auto",
                      device=cuda_device)
    assert plan.auto.source == "store"
    assert (plan.key.backend, plan.key.fuse) == (best.backend, best.fuse)
    # the card's records never steer a CPU key
    cpu = E.get_plan(shape=(2, 256, 256), levels=2, backend="auto",
                     device="cpu")
    assert cpu.auto.source == "heuristic"
    assert TW.KERNEL.launches > 0


def _serve(cfg, imgs, **kw):
    import asyncio
    from repro_torch.serve import DwtServer

    async def run():
        async with DwtServer(cfg) as srv:
            out = await asyncio.gather(*[srv.submit(im, **kw)
                                         for im in imgs])
            return out, srv
    return asyncio.run(asyncio.wait_for(run(), 120))


@pytest.mark.parametrize("backend,fuse", [("cuda", "pyramid"),
                                          ("cuda", "levels"),
                                          ("cuda", "none")])
def test_served_results_equal_direct_calls_on_the_card(cuda_device,
                                                       auto_files, backend,
                                                       fuse):
    import numpy as np
    from repro_torch.serve import ServeConfig
    imgs = _images_np(11, 256, 256)
    kw = dict(levels=3, backend=backend, fuse=fuse)
    served, _ = _serve(ServeConfig(max_batch=4, num_workers=2,
                                   max_wait_ms=2.0), imgs, **kw)
    for s, im in zip(served, imgs):
        want = R.dwt2(torch.from_numpy(im), device=cuda_device, **kw)
        for a, b in zip(_all_planes(want), [s.ll] +
                        [d for dd in s.details for d in dd]):
            assert np.array_equal(a.cpu().numpy(), b)


def test_two_workers_run_on_their_own_streams_and_count_exactly(
        cuda_device, auto_files):
    from repro_torch.kernels import pyramid_window as PW
    from repro_torch.serve import ServeConfig, serve_stats
    imgs = _images_np(32, 128, 128, seed=3)
    n = PW.FORWARD.launches
    served, srv = _serve(ServeConfig(max_batch=2, num_workers=2,
                                     max_wait_ms=0.5), imgs, levels=2,
                         fuse="pyramid")
    st = serve_stats()
    assert st["served"] == 32
    assert PW.FORWARD.launches - n == st["batches"]
    assert srv._streams == {}               # released at stop
    assert len(served) == 32


def test_served_outputs_and_staging_are_pinned(cuda_device, auto_files):
    import asyncio
    from repro_torch.serve import DwtServer, ServeConfig
    imgs = _images_np(3, 128, 128, seed=4)

    async def run():
        srv = DwtServer(ServeConfig(max_batch=4, num_workers=1,
                                    max_wait_ms=2.0))
        async with srv:
            out = await asyncio.gather(*[srv.submit(im, levels=2)
                                         for im in imgs])
            stages = [t for d in srv._stages.values() for t, _ in
                      d.values()]
            streams = list(srv._streams.values())
            return out, stages, streams
    out, stages, streams = asyncio.run(asyncio.wait_for(run(), 120))
    assert stages and all(t.is_pinned() for t in stages)
    assert len(streams) == 1 and streams[0] != torch.cuda.default_stream()
    # every request's planes are views of its batch's pinned buffer
    for pyr in out:
        for a in [pyr.ll] + [d for dd in pyr.details for d in dd]:
            assert torch.from_numpy(a).is_pinned()


# ---------------------------------------------------------------------------
# Gradient compression and the LM training path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(537600, 256), (4864, 96), (17, 31)])
def test_compression_k1_equals_plain_version(cuda_device, monkeypatch,
                                             shape):
    """compress/decompress on the card: every K1 launch equals the plain
    version on the same planes bit for bit, 8 launches per tensor at 2
    levels, and the result equals the same calls on the CPU to
    CROSS_TOL (the first shape is qwen2-0.5b's tied embedding tile)."""
    from repro_torch.core import compression as CMP
    if shape[0] == 537600:
        g = torch.randn(153600, 896, generator=torch.Generator(
            device=cuda_device).manual_seed(0), device=cuda_device)
    else:
        g = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                        ).to(cuda_device)
    worst = []
    kernel = TW.tap_window

    def versus_plain(win, src, **kw):
        out = kernel(win, src, **kw)
        ref = TW.tap_window_ref(win, src, **kw)
        worst.append(max(float((a - b).abs().max())
                         for a, b in zip(_outputs(out), _outputs(ref))))
        return out

    monkeypatch.setattr(TW, "tap_window", versus_plain)
    n = TW.KERNEL.launches
    c = CMP.compress(g, 5, 2)
    back = CMP.decompress(c, 5, g.shape, 2)
    torch.cuda.synchronize()
    assert TW.KERNEL.launches - n == 8 and len(worst) == 8
    assert max(worst) == 0.0
    h, w = CMP.tile_shape(g.numel(), 2)
    assert c.numel() * 16 == h * w
    if g.numel() < 10 ** 6:
        monkeypatch.setattr(TW, "tap_window", kernel)
        c_cpu = CMP.compress(g.cpu(), 5, 2)
        torch.testing.assert_close(c.cpu(), c_cpu, **CROSS_TOL["float32"])
        torch.testing.assert_close(
            back.cpu(), CMP.decompress(c_cpu, 5, g.shape, 2),
            **CROSS_TOL["float32"])


def test_train_step_at_full_width_on_the_card(cuda_device):
    """One compressed train step of qwen2-0.5b at full width, depth cut
    to 2 layers: finite loss, every parameter moved, K1 launched by
    compression exactly as the plans say (14 leaves x 8), and prefill +
    decode against forward within the reference's 2e-2."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.configs.qwen2_0_5b import FULL, RUN
    from repro_torch.runtime import steps as ST
    cfg = dataclasses.replace(FULL, n_layers=2)
    run = dataclasses.replace(RUN, grad_compression="dwt:2")
    state = ST.init_train_state(torch.Generator(
        device=cuda_device).manual_seed(0), cfg, run, device=cuda_device)
    before = pytree.leaves(state.params)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    n = TW.KERNEL.launches
    state, m = ST.train_step(state, {"tokens": toks}, cfg, run)
    torch.cuda.synchronize()
    assert TW.KERNEL.launches - n == 14 * 8
    assert bool(torch.isfinite(m["loss"])) and int(state.step) == 1
    moved = [bool((a != b.detach()).any())
             for a, b in zip(before, pytree.leaves(state.params))]
    assert all(moved)
    with torch.no_grad():
        full, _ = ST.lm.forward(state.params, toks[:2, :17], cfg)
        lg, cache = ST.prefill_step(state.params, {"tokens": toks[:2, :16]},
                                    cfg, 32)
        lg1, _ = ST.decode_step(state.params, cache, toks[:2, 16:17], cfg)
    v = cfg.vocab_size
    lsm = lambda x: torch.log_softmax(x.float()[..., :v], -1)
    assert float((lsm(lg) - lsm(full[:, 15])).abs().max()) < 2e-2
    assert float((lsm(lg1) - lsm(full[:, 16])).abs().max()) < 2e-2


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-medium"])
def test_family_train_step_on_the_card(cuda_device, arch):
    """One compressed train step of each MoE, RWKV6, hybrid and whisper
    SMOKE config on the card: finite loss (the MoE aux loss above 0),
    every parameter moved, and K1 launched by compression exactly as the
    plans say (8 per leaf at 2 levels)."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.runtime import steps as ST
    cfg, run = get_config(arch, smoke=True)
    run = dataclasses.replace(run, grad_compression="dwt:2", grad_accum=2)
    state = ST.init_train_state(torch.Generator(
        device=cuda_device).manual_seed(0), cfg, run, device=cuda_device)
    before = [p.clone() for p in pytree.leaves(state.params)]
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in make_pipeline(cfg).batch_at(
                 0, ShapeConfig("s", "train", 64, 4)).items()}
    n = TW.KERNEL.launches
    state, m = ST.train_step(state, batch, cfg, run)
    torch.cuda.synchronize()
    assert TW.KERNEL.launches - n == 8 * len(before)
    assert bool(torch.isfinite(m["loss"])) and int(state.step) == 1
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    assert all(bool((a != b).any())
               for a, b in zip(before, pytree.leaves(state.params)))


REVERSIBLE = dict(wavelet="rev53", scheme="sep-lifting",
                  boundary="symmetric")


@pytest.mark.parametrize("shape", [(1, 2, 2), (3, 66, 130), (5, 96, 200),
                                   (2, 2, 1026), (1, 1030, 6),
                                   (2, 3, 64, 64), (1871, 512, 512)])
def test_rev_lift_equals_the_plain_path(cuda_device, shape):
    """The reversible lifting kernel against the plain integer path on
    the same int32 tensors, forward and inverse, bit for bit: partial
    tiles, 2-sample edges, batch dims and the lossless cell's series."""
    from repro_torch.core import reversible as RV
    from repro_torch.kernels import rev_lift as RL
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randint(-2048, 2048, shape, generator=g, device=cuda_device,
                      dtype=torch.int32)
    before = RL.KERNEL.launches
    got = RL.rev_lift_forward(x)
    want = RV.level_forward(x, "rev53")
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    back = RL.rev_lift_inverse(got)
    assert torch.equal(back, RV.level_inverse(want, "rev53"))
    assert torch.equal(back, x)
    assert RL.KERNEL.launches - before == 2


def test_rev53_runs_the_kernel_through_the_plan(cuda_device):
    """``dwt2``/``idwt2`` of rev53 on "cuda": one launch a level and
    direction, every subband equal to backend "torch" on the same card
    tensors, the round trip exact, no fallback."""
    from repro_torch.faults import degrade
    from repro_torch.kernels import rev_lift as RL
    g = torch.Generator(device=cuda_device).manual_seed(28)
    x = torch.randint(-2048, 2048, (4, 512, 512), generator=g,
                      device=cuda_device, dtype=torch.int32)
    hops = degrade.stats()["fallbacks"]
    before = RL.KERNEL.launches
    pyr = R.dwt2(x, levels=5, fuse="levels", **REVERSIBLE)
    rec = R.idwt2(pyr, fuse="levels", **REVERSIBLE)
    assert RL.KERNEL.launches - before == 10
    plain = R.dwt2(x, levels=5, backend="torch", **REVERSIBLE)
    for a, b in zip([pyr.ll] + [t for d in pyr.details for t in d],
                    [plain.ll] + [t for d in plain.details for t in d]):
        assert torch.equal(a, b)
    assert torch.equal(rec, x)
    assert degrade.stats()["fallbacks"] == hops
