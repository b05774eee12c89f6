"""The CUDA window kernel on the card, against its plain version.

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


def test_wrapper_rejects_non_contiguous_planes(cuda_device):
    prog = C.compile_scheme_programs("cdf53", "ns-conv", False, False,
                                     "full", "none")[0]
    win = TW.encode(prog, (8, 8))
    planes = [p.transpose(1, 2) for p in _planes((1, 16, 8), cuda_device)]
    with pytest.raises(ValueError, match="contiguous"):
        TW.tap_window(win, planes)
