"""The fused-pyramid path (``fuse="pyramid"``) of the port, on the CPU.

The CUDA kernels K2/K3 themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  Here:

* the margin schedules, per-level reaches, aligned block picks and the
  subband order against the reference package's, exactly, for every
  wavelet x scheme x optimize x tap_opt x levels 1-5 x direction;
* ``dwt2``/``idwt2(fuse="pyramid", backend="cuda", device="cpu")`` (the
  kernels' plain versions) against the reference's Pallas pyramid
  kernels run as its own tests run them (interpret mode), and round trips;
* the encoded pyramid tables against a NumPy walk of them that mirrors
  ``csrc/pyramid_window.cu`` level by level and tile by tile — K2's
  gather split at stride 2 from the level's image, K3's interleaving
  sink, the LL through the I/O dtype between levels and the masked
  ragged edge — bit for bit against the plain versions;
* the shared-memory guard and its fallback to ``fuse="levels"``, the
  launch and work model, the wrappers' checks, and the float row mapping
  the kernels share with the window kernel.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as JC
from repro import engine as JE
from repro.core import transform as JT
from repro.core.schemes import SCHEMES
from repro.engine.plan import scheme_steps as j_scheme_steps
from repro.kernels import polyphase as JPP

import repro_torch as R
from repro_torch import compiler as TC
from test_torch_window import walk_table
from repro_torch import engine as TE
from repro_torch.engine import plan as TPLAN
from repro_torch.kernels.polyphase import scheme_steps as t_scheme_steps
from repro_torch.kernels import polyphase as TPP
from repro_torch.kernels import pyramid_window as PW
from repro_torch.kernels import tap_window as TW

WAVELETS = ("cdf53", "cdf97", "dd137")
OPT_LEVELS = ("off", "exact", "full")
# tests/test_differential.py CROSS_TOL / ROUNDTRIP_TOL (float32)
CROSS_TOL = dict(rtol=2e-4, atol=2e-5)
ROUNDTRIP_TOL = dict(rtol=1e-3, atol=1e-4)


def _image(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _planes_np(pyr):
    """Pyramid -> [LL, coarsest details, ..., finest details] as float32."""
    planes = [pyr.ll] + [d for det in pyr.details for d in det]
    return [np.asarray(p.float() if isinstance(p, torch.Tensor) else p,
                       dtype=np.float32) for p in planes]


def _assert_close(got, ref, tol):
    g, r = _planes_np(got), _planes_np(ref)
    assert [a.shape for a in g] == [b.shape for b in r]
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, **tol)


def _kernels(wavelet, scheme, levels, tap_opt="full"):
    """The pyramid spec a cuda plan resolves for a 2048x2048 image (the
    guard's largest admissible block), or None where it falls back."""
    key = TE.PlanKey(wavelet=wavelet, scheme=scheme, levels=levels,
                     shape=(2048, 2048), dtype="float32", backend="cuda",
                     optimize=False, fuse="pyramid", boundary="periodic",
                     tap_opt=tap_opt, device="cpu")
    spec, _ = TPLAN._resolve_pyramid(key, 2048, 2048)
    return spec


# ---------------------------------------------------------------------------
# schedules, reaches, blocks and subband order: exact parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_schedules_equal_reference(wavelet, scheme):
    for optimize, tap_opt, levels, inverse in itertools.product(
            (False, True), OPT_LEVELS, range(1, 6), (False, True)):
        opt = optimize and not inverse
        jprogs = JC.compile_pyramid_programs(wavelet, scheme, opt, inverse,
                                             tap_opt, levels)
        tprogs = TC.compile_pyramid_programs(wavelet, scheme, opt, inverse,
                                             tap_opt, levels)
        assert (jprogs is None) == (tprogs is None)
        if jprogs is not None:
            assert [p.halo for p in jprogs] == [p.halo for p in tprogs]
        jr = JC.level_reaches(j_scheme_steps(wavelet, scheme, opt, inverse),
                              jprogs, levels)
        tr = TC.level_reaches(t_scheme_steps(wavelet, scheme, opt, inverse),
                              tprogs, levels)
        assert jr == tr
        make = "inverse_schedule" if inverse else "forward_schedule"
        js = getattr(JC, make)(jr, levels)
        ts = getattr(TC, make)(tr, levels)
        assert dataclasses.astuple(js) == dataclasses.astuple(ts)
        assert js.halo == ts.halo


@pytest.mark.parametrize("levels", (1, 3, 5))
@pytest.mark.parametrize("scheme", ("ns-polyconv", "sep-lifting"))
def test_plan_schedules_equal_reference_plan(scheme, levels, monkeypatch):
    """The schedules a cuda plan resolves are the reference pallas plan's,
    with both budgets lifted (each guard has its own memory).  The blocks
    are the port's own: both kernels walk each level at the tile the
    window kernel's guard picks for the level's two programs, and the
    image-space block is twice the level-0 tile."""
    monkeypatch.setenv(JE.plan.PYRAMID_VMEM_LIMIT_ENV, str(1 << 40))
    monkeypatch.setenv(TPLAN.PYRAMID_SMEM_LIMIT_ENV, str(1 << 40))
    for tap_opt in OPT_LEVELS:
        key = TE.PlanKey(wavelet="cdf97", scheme=scheme, levels=levels,
                         shape=(2, 64, 96), dtype="float32", backend="cuda",
                         optimize=False, fuse="pyramid",
                         boundary="periodic", tap_opt=tap_opt, device="cpu")
        jkey = JE.PlanKey(wavelet="cdf97", scheme=scheme, levels=levels,
                          shape=(2, 64, 96), dtype="float32",
                          backend="pallas", optimize=False, fuse="pyramid",
                          boundary="periodic", tap_opt=tap_opt)
        tspec, _ = TPLAN._resolve_pyramid(key, 64, 96)
        jspec, _ = JE.plan._resolve_pyramid(jkey, 64, 96, TW.BLOCK_TARGET)
        for a, b in ((tspec.fwd_sched, jspec.fwd_sched),
                     (tspec.inv_sched, jspec.inv_sched)):
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        _, _, fprogs, iprogs = TPLAN.pyramid_programs(key)
        tiles = tuple(TW.fit_block((fp, ip), 32 >> l, 48 >> l)
                      for l, (fp, ip) in enumerate(zip(fprogs, iprogs)))
        assert tspec.fwd_kernel.level_blocks == \
            tspec.inv_kernel.level_blocks == tiles
        bh, bw = tspec.block
        assert (bh, bw) == (2 * tiles[0][0], 2 * tiles[0][1])
        assert tspec.covered_shape == (-(-64 // bh) * bh, -(-96 // bw) * bw)


def test_out_levels_equal_reference():
    for levels in range(1, 9):
        assert TPP.pyramid_out_levels(levels) == \
            JPP.pyramid_out_levels(levels)


# ---------------------------------------------------------------------------
# end-to-end parity with the reference's Pallas pyramid (interpret mode)
# ---------------------------------------------------------------------------

def _port_pyramid(x, **kw):
    return R.dwt2(torch.from_numpy(x), backend="cuda", fuse="pyramid",
                  device="cpu", **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pyramid_matches_reference_pallas_pyramid(scheme):
    """Two levels on 32x48, the port's pyramid path vs the reference's
    single-pallas_call pyramid, forward and inverse, and round trip."""
    x = _image((32, 48), seed=2)
    kw = dict(wavelet="cdf97", levels=2, scheme=scheme)
    ref = JT.dwt2(jnp.asarray(x), backend="pallas", fuse="pyramid", **kw)
    pyr = _port_pyramid(x, **kw)
    _assert_close(pyr, ref, CROSS_TOL)
    rec = R.idwt2(pyr, wavelet="cdf97", scheme=scheme, backend="cuda",
                  fuse="pyramid", device="cpu")
    np.testing.assert_allclose(rec.numpy(), x, **ROUNDTRIP_TOL)
    ref_rec = JT.idwt2(ref, wavelet="cdf97", scheme=scheme,
                       backend="pallas", fuse="pyramid")
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_rec),
                               **CROSS_TOL)


@pytest.mark.parametrize("case", ["batched", "multiblock", "odd-off"])
def test_pyramid_matches_reference_pallas_cases(case):
    """(B, C, H, W) input; a multi-block reference grid (block target
    (8, 16)); odd 12x20 planes under tap_opt="off" (the reference walks
    raw matrices, the port the lowered raw walk)."""
    if case == "batched":
        x = _image((2, 2, 32, 32), seed=4)
        kw = dict(wavelet="cdf97", levels=2, scheme="sep-lifting")
        ref = JT.dwt2(jnp.asarray(x), backend="pallas", fuse="pyramid",
                      **kw)
    elif case == "multiblock":
        x = _image((2, 32, 64), seed=5)
        kw = dict(wavelet="cdf97", levels=2, scheme="ns-polyconv")
        key = JE.PlanKey(wavelet="cdf97", scheme="ns-polyconv", levels=2,
                         shape=(2, 32, 64), dtype="float32",
                         backend="pallas", optimize=False, fuse="pyramid",
                         boundary="periodic")
        plan = JE.build_plan(key, block_target=(8, 16))
        assert plan.pyramid is not None and plan.pyramid.block == (16, 32)
        ref = plan.execute(jnp.asarray(x))
    else:
        x = _image((24, 40), seed=3)
        kw = dict(wavelet="cdf97", levels=2, scheme="ns-polyconv",
                  tap_opt="off")
        ref = JT.dwt2(jnp.asarray(x), backend="pallas", fuse="pyramid",
                      **kw)
    pyr = _port_pyramid(x, **kw)
    assert tuple(pyr.ll.shape) == tuple(ref.ll.shape)
    _assert_close(pyr, ref, CROSS_TOL)
    kw.pop("levels")
    rec = R.idwt2(pyr, backend="cuda", fuse="pyramid", device="cpu", **kw)
    np.testing.assert_allclose(rec.numpy(), x, **ROUNDTRIP_TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_pyramid_equals_levels_on_cpu(scheme):
    """On the CPU the plain versions are the per-level chain: fuse=
    "pyramid" equals fuse="levels" bit for bit, at three levels, batched,
    for both directions."""
    x = torch.from_numpy(_image((2, 40, 56), seed=6))
    kw = dict(wavelet="dd137", levels=3, scheme=scheme, backend="cuda",
              device="cpu")
    a = R.dwt2(x, fuse="pyramid", **kw)
    b = R.dwt2(x, fuse="levels", **kw)
    for p, q in zip(_planes_np(a), _planes_np(b)):
        np.testing.assert_array_equal(p, q)
    kw.pop("levels")
    ra = R.idwt2(a, fuse="pyramid", **kw)
    rb = R.idwt2(a, fuse="levels", **kw)
    np.testing.assert_array_equal(ra.numpy(), rb.numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_torch_backend_pyramid_is_the_level_chain(scheme):
    x = torch.from_numpy(_image((2, 32, 48), seed=7))
    kw = dict(levels=3, scheme=scheme, backend="torch", device="cpu")
    a = R.dwt2(x, fuse="pyramid", **kw)
    b = R.dwt2(x, fuse="none", **kw)
    for p, q in zip(_planes_np(a), _planes_np(b)):
        np.testing.assert_array_equal(p, q)


# ---------------------------------------------------------------------------
# plan: launches, the shared-memory guard and its fallback
# ---------------------------------------------------------------------------

def test_cuda_pyramid_plan_is_one_launch():
    plan = TE.get_plan(shape=(8, 2048, 2048), levels=3,
                       scheme="ns-polyconv", fuse="pyramid", backend="cuda",
                       device="cpu", cache=TE.PlanCache())
    assert plan.pyramid is not None and plan.fallback is None
    assert plan.launches == 1
    spec = plan.pyramid
    # both kernels walk each level at the block fuse="levels" picks
    assert spec.fwd_kernel.level_blocks == spec.inv_kernel.level_blocks \
        == tuple(ls.block for ls in plan.level_specs) == ((32, 32),) * 3
    assert spec.block == (64, 64) and spec.covered_shape == (2048, 2048)
    assert spec.fwd_sched.margins == (32, 12, 4, 0)
    assert spec.inv_sched.margins == (0, 2, 4, 4)
    assert spec.smem_bytes <= TW.SMEM_LIMIT
    caps = {c["backend"]: c for c in TE.capability_matrix()}
    assert caps["cuda"]["pyramid_kernel"] and "pyramid" in \
        caps["cuda"]["fuse_modes"]
    assert not caps["torch"]["pyramid_kernel"]


def test_forward_pyramid_does_the_work_of_fuse_levels():
    """The forward kernel's term evaluations are those of the per-level
    path's window kernel launches, exactly (the main path: 1.10e9 at
    8 x 2048 x 2048, against 4.32e9 for a level-0 window carrying the
    compound margin)."""
    shape = (8, 2048, 2048)
    plan = TE.get_plan(shape=shape, levels=3, scheme="ns-polyconv",
                       fuse="levels", backend="cuda", device="cpu",
                       cache=TE.PlanCache())
    levels = sum(win.term_evaluations((8,) + ls.plane_shape)
                 for ls in plan.level_specs for win in ls.fwd_windows)
    spec = _kernels("cdf97", "ns-polyconv", 3)
    assert spec.fwd_kernel.term_evaluations(shape) == levels == 1098080256
    assert spec.fwd_kernel.level_tiles(shape) == (8192, 2048, 512)


def test_inverse_pyramid_does_the_work_of_fuse_levels():
    """The inverse kernel's term evaluations are those of the per-level
    path's inverse window kernel launches, exactly: 1,098,080,256 at the
    main path (the compound-margin design did 1,190,658,048), at the same
    tiles and the same shared memory as the forward kernel (74,992 B,
    three blocks per SM)."""
    shape = (8, 2048, 2048)
    plan = TE.get_plan(shape=shape, levels=3, scheme="ns-polyconv",
                       fuse="levels", backend="cuda", device="cpu",
                       cache=TE.PlanCache())
    levels = sum(win.term_evaluations((8,) + ls.plane_shape)
                 for ls in plan.level_specs for win in ls.inv_windows)
    spec = _kernels("cdf97", "ns-polyconv", 3)
    inv = spec.inv_kernel
    assert inv.term_evaluations(shape) == levels == 1098080256
    assert inv.level_tiles(shape) == (8192, 2048, 512)
    assert inv.smem_bytes == spec.fwd_kernel.smem_bytes == 74992
    assert TW.resident_blocks(inv.smem_bytes) == 3


def test_smem_guard_falls_back_to_levels(monkeypatch):
    """A tiny budget: the plan demotes to fuse="levels", says why,
    counts it, and computes exactly what fuse="levels" computes."""
    monkeypatch.setenv(TPLAN.PYRAMID_SMEM_LIMIT_ENV, "4096")
    before = dict(TE.PYRAMID_COUNTERS)
    key = TE.PlanKey(wavelet="cdf97", scheme="ns-polyconv", levels=2,
                     shape=(2, 32, 48), dtype="float32", backend="cuda",
                     optimize=False, fuse="pyramid", boundary="periodic",
                     device="cpu")
    plan = TE.build_plan(key)
    assert plan.pyramid is None
    assert "executing as fuse='levels'" in plan.fallback
    assert TE.PYRAMID_COUNTERS["smem_fallbacks"] == \
        before["smem_fallbacks"] + 1
    assert plan.launches == 2
    x = torch.from_numpy(_image((2, 32, 48), seed=8))
    got = plan.execute(x)
    want = R.dwt2(x, levels=2, fuse="levels", device="cpu")
    for p, q in zip(_planes_np(got), _planes_np(want)):
        np.testing.assert_array_equal(p, q)
    assert TE.PYRAMID_COUNTERS["pyramid_kernel_launches"] == \
        before["pyramid_kernel_launches"]


def test_deep_separable_pyramid_resolves_at_default_budget():
    """L=7 cdf97 sep-lifting, which fell back while the inverse kernel's
    windows carried the compound margin: the inverse kernel now walks
    each level with its own halo, down to the 2x2 planes of level 6, and
    the plan is one launch per direction."""
    before = TE.PYRAMID_COUNTERS["smem_fallbacks"]
    plan = TE.get_plan(shape=(1, 256, 256), levels=7, scheme="sep-lifting",
                       fuse="pyramid", backend="cuda", device="cpu",
                       cache=TE.PlanCache())
    assert plan.pyramid is not None and plan.fallback is None
    assert plan.launches == 1
    assert plan.pyramid.inv_kernel.level_tiles((1, 256, 256))[-1] == 1
    assert plan.pyramid.smem_bytes <= TW.SMEM_LIMIT
    assert TE.PYRAMID_COUNTERS["smem_fallbacks"] == before


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_seven_level_pyramids_resolve_at_default_budget(wavelet, scheme):
    """Every wavelet x scheme x tap_opt at seven levels (256x256) resolves
    to one launch per direction: no level of either kernel overflows the
    default shared-memory budget."""
    for tap_opt in OPT_LEVELS:
        key = TE.PlanKey(wavelet=wavelet, scheme=scheme, levels=7,
                         shape=(1, 256, 256), dtype="float32",
                         backend="cuda", optimize=False, fuse="pyramid",
                         boundary="periodic", tap_opt=tap_opt, device="cpu")
        spec, why = TPLAN._resolve_pyramid(key, 256, 256)
        assert spec is not None, (tap_opt, why)
        assert spec.smem_bytes <= TW.SMEM_LIMIT


def test_five_level_separable_pyramid_now_fits():
    """L=5 cdf97 sep-lifting, which fell back while the forward kernel's
    level-0 window carried the 288-pixel compound margin: the forward
    kernel now walks each level with its own halo, and both kernels
    fit."""
    before = TE.PYRAMID_COUNTERS["smem_fallbacks"]
    plan = TE.get_plan(shape=(1, 256, 256), levels=5, scheme="sep-lifting",
                       fuse="pyramid", backend="cuda", device="cpu",
                       cache=TE.PlanCache())
    assert plan.pyramid is not None and plan.launches == 1
    assert plan.pyramid.fwd_sched.margins[0] == 288
    assert plan.pyramid.smem_bytes <= TW.SMEM_LIMIT
    assert TE.PYRAMID_COUNTERS["smem_fallbacks"] == before


def test_forward_guard_names_the_forward_kernel(monkeypatch):
    """A budget below one level's window: the forward kernel is the one
    that does not fit, and the fallback says so."""
    monkeypatch.setenv(TPLAN.PYRAMID_SMEM_LIMIT_ENV, "4096")
    plan = TE.get_plan(shape=(1, 256, 256), levels=2, scheme="ns-polyconv",
                       fuse="pyramid", backend="cuda", device="cpu",
                       cache=TE.PlanCache())
    assert plan.pyramid is None
    assert plan.fallback.startswith("forward pyramid")


def test_inverse_guard_names_the_inverse_kernel(monkeypatch):
    """A budget between the two kernels' smallest level footprints (the
    optimized cdf97 ns-polyconv forward program needs 9,008 B at the 8x8
    tile, its inverse 9,840 B): only the inverse kernel does not fit; the
    plan falls back to fuse="levels", names the inverse, counts it and
    computes exactly what fuse="levels" computes."""
    monkeypatch.setenv(TPLAN.PYRAMID_SMEM_LIMIT_ENV, "9500")
    before = TE.PYRAMID_COUNTERS["smem_fallbacks"]
    key = TE.PlanKey(wavelet="cdf97", scheme="ns-polyconv", levels=2,
                     shape=(2, 32, 48), dtype="float32", backend="cuda",
                     optimize=True, fuse="pyramid", boundary="periodic",
                     device="cpu")
    plan = TE.build_plan(key)
    assert plan.pyramid is None and plan.launches == 2
    assert plan.fallback.startswith("inverse pyramid: level 0's")
    assert plan.fallback.endswith("executing as fuse='levels'")
    assert TE.PYRAMID_COUNTERS["smem_fallbacks"] == before + 1
    x = torch.from_numpy(_image((2, 32, 48), seed=10))
    pyr = plan.execute(x)
    want = R.idwt2(pyr, fuse="levels", device="cpu")
    np.testing.assert_array_equal(plan.execute_inverse(pyr).numpy(),
                                  want.numpy())


def test_pyramid_counter_counts_executions():
    before = TE.PYRAMID_COUNTERS["pyramid_kernel_launches"]
    x = torch.from_numpy(_image((16, 16), seed=9))
    pyr = R.dwt2(x, levels=2, fuse="pyramid", device="cpu")
    R.idwt2(pyr, fuse="pyramid", device="cpu")
    assert TE.PYRAMID_COUNTERS["pyramid_kernel_launches"] == before + 2


@pytest.mark.parametrize("levels", (1, 2, 3, 4))
def test_smem_bytes_is_what_the_kernel_lays_out(levels):
    """The guard's sizes, for both kernels: the largest window kernel
    footprint of their levels, each from its own table header (table,
    front pad, four input windows and the slots at the level's tile, back
    pad), and the pyramid header's largest level table."""
    spec = _kernels("cdf53", "ns-polyconv", levels)
    for pw in (spec.fwd_kernel, spec.inv_kernel):
        assert int(pw.table[0]) == levels
        need = []
        for (tab, bh, bw), blk in zip(_levels_of(pw), pw.level_blocks):
            n_slots, halo, wh, ww, front, back, elems = (
                int(v) for v in tab[4:11])
            assert (bh, bw) == blk and elems == pw.elems
            assert (wh, ww) == (bh + 2 * halo, bw + 2 * halo)
            need.append(4 * (-(-len(tab) // 4) * 4 + front
                             + (4 + n_slots) * wh * ww + back))
        assert pw.smem_bytes == max(need)
        assert int(pw.table[1]) == max(len(t) for t, _, _ in _levels_of(pw))


def test_hbm_model_of_the_main_path():
    """Both directions: every level's four windows with their halo
    overlap, every output written once (the forward's subbands and LL,
    the inverse's interleaved image), so each intermediate LL is written
    once and read once."""
    spec = _kernels("cdf97", "ns-polyconv", 3)
    fwd, inv = (TPP.pyramid_hbm_bytes((2048, 2048), 4, pw.level_blocks,
                                      [p.halo for p in pw.programs])
                for pw in (spec.fwd_kernel, spec.inv_kernel))
    assert fwd.unique == inv.unique == 2 * 2048 * 2048 * 4
    reads = sum(4 * ((1024 >> l) // 32) ** 2 * 36 * 36 for l in range(3))
    writes = sum(4 * (1024 >> l) ** 2 for l in range(3))
    assert fwd.modelled == inv.modelled == (reads + writes) * 4
    # the intermediate LLs' write and read: 1.33x the unique bytes here
    assert inv.modelled > inv.unique


# ---------------------------------------------------------------------------
# the encoded pyramid tables, walked as csrc/pyramid_window.cu walks them
# ---------------------------------------------------------------------------

def _bf16(a):
    """Round float32 to bfloat16 (round to nearest even), kept in float32."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


_ROUND_IO = {torch.float32: lambda a: a,
             torch.float16: lambda a: a.astype(np.float16)
             .astype(np.float32),
             torch.bfloat16: _bf16}


def _levels_of(pw):
    """(table, bh, bw) per level: the level's window table and its plane
    tile."""
    L = int(pw.table[0])
    out = []
    for l in range(L):
        row = PW._PYR_HEADER + PW._LEVEL_INTS * l
        off, a, b, _ = (int(v) for v in pw.table[row:row + 4])
        n_waves, n_nodes, n_terms = (int(v) for v in
                                     pw.table[off + 1:off + 4])
        n = (TW._HEADER + TW._WAVE_INTS * n_waves + TW._NODE_INTS * n_nodes
             + 2 * n_terms)
        out.append((pw.table[off:off + n], a, b))
    return out


def emulate_forward(pw, x, io=torch.float32):
    """NumPy walk of K2: level by level, every tile of the level's plane
    grid gathers its four polyphase windows from the level's image (the
    input, then the LL scratch of the level before), mod the image dims,
    walks the level table (:func:`walk_table`) and stores the core: HL,
    LH, HH to the outputs, LL to the next level's image (rounded through
    the I/O dtype, as the scratch stores it).  ``x`` (B, H, W) float32
    holds values of the I/O dtype ``io``; returns [LL, HL_0, LH_0, HH_0,
    ...] in pyramid_out_levels order."""
    rnd = _bf16 if pw.compute_dtype == "bfloat16" else (lambda a: a)
    rio = _ROUND_IO[io]
    nb, h, w = x.shape
    levels = _levels_of(pw)
    L = len(levels)
    outs = [np.full((nb, h >> (l + 1), w >> (l + 1)), np.nan, np.float32)
            for l in TPP.pyramid_out_levels(L)]
    img = x
    for l, (tab, bh, bw) in enumerate(levels):
        r, wh, ww = (int(v) for v in tab[5:8])
        assert (wh, ww) == (bh + 2 * r, bw + 2 * r)
        H, W = h >> l, w >> l
        hp, wp = H // 2, W // 2
        last = l + 1 == L
        ll = outs[0] if last else np.full((nb, hp, wp), np.nan, np.float32)
        dst = [ll] + outs[1 + 3 * l:4 + 3 * l]
        for y0, x0 in itertools.product(range(0, hp, bh), range(0, wp, bw)):
            rows = (2 * (y0 - r + np.arange(wh))) % H
            cols = (2 * (x0 - r + np.arange(ww))) % W
            inputs = [img[:, rows + (j >> 1)][:, :, cols + (j & 1)]
                      for j in range(4)]

            def sink(mask, q, vals, y0=y0, x0=x0):
                y, xx = q // ww, q % ww
                gy, gx = y0 + y - r, x0 + xx - r
                keep = ((y >= r) & (y < r + bh) & (xx >= r) & (xx < r + bw)
                        & (gy < hp) & (gx < wp))
                for k in range(4):
                    if mask >> k & 1:
                        dst[k][:, gy[keep], gx[keep]] = rio(vals[:, keep])
            walk_table(tab, nb, inputs, sink, rnd)
        assert not np.isnan(ll).any()
        img = ll
    return outs


def emulate_inverse(pw, subbands, io=torch.float32):
    """NumPy walk of K3: level by level from the coarsest, every tile of
    the level's plane grid gathers its four windows (the LL, the input at
    the coarsest level and then the image the level before wrote, and the
    level's HL, LH, HH), mod the plane dims, walks the level table
    (:func:`walk_table`), and the interleaving sink writes output ``k`` at
    plane position (i, j) of the core to pixel (2i + (k >> 1), 2j + (k &
    1)) of the level's image, rounded through the I/O dtype ``io`` (the
    scratch, or at level 0 the output).  ``subbands`` float32 in
    pyramid_out_levels order; returns the (B, H, W) image."""
    rnd = _bf16 if pw.compute_dtype == "bfloat16" else (lambda a: a)
    rio = _ROUND_IO[io]
    levels = _levels_of(pw)
    L = len(levels)
    nb = subbands[0].shape[0]
    h, w = subbands[0].shape[1] << L, subbands[0].shape[2] << L
    ll = subbands[0]
    for l in range(L - 1, -1, -1):
        tab, bh, bw = levels[l]
        r, wh, ww = (int(v) for v in tab[5:8])
        assert (wh, ww) == (bh + 2 * r, bw + 2 * r)
        hp, wp = h >> (l + 1), w >> (l + 1)
        img = np.full((nb, 2 * hp, 2 * wp), np.nan, np.float32)
        planes = [ll] + list(subbands[1 + 3 * l:4 + 3 * l])
        for y0, x0 in itertools.product(range(0, hp, bh), range(0, wp, bw)):
            rows = (y0 - r + np.arange(wh)) % hp
            cols = (x0 - r + np.arange(ww)) % wp
            inputs = [p[:, rows][:, :, cols] for p in planes]

            def sink(mask, q, vals, y0=y0, x0=x0):
                y, xx = q // ww, q % ww
                gy, gx = y0 + y - r, x0 + xx - r
                keep = ((y >= r) & (y < r + bh) & (xx >= r) & (xx < r + bw)
                        & (gy < hp) & (gx < wp))
                for k in range(4):
                    if mask >> k & 1:
                        img[:, 2 * gy[keep] + (k >> 1),
                            2 * gx[keep] + (k & 1)] = rio(vals[:, keep])
            walk_table(tab, nb, inputs, sink, rnd)
        assert not np.isnan(img).any()
        ll = img
    return ll


def _emulation_case(wavelet, scheme, levels, tap_opt, inv_block, shape,
                    io=torch.float32, compute="float32", seed=0,
                    fwd_block=(4, 8)):
    """K2 at the plane tile ``fwd_block`` and K3 at ``inv_block`` on every
    level, against their plain versions bit for bit."""
    key = TE.PlanKey(wavelet=wavelet, scheme=scheme, levels=levels,
                     shape=shape, dtype="float32", backend="cuda",
                     optimize=False, fuse="pyramid", boundary="periodic",
                     tap_opt=tap_opt, device="cpu")
    fs, isch, fprogs, iprogs = TPLAN.pyramid_programs(key)
    fwd = PW.encode_forward(fprogs, fs, [fwd_block] * levels, compute)
    inv = PW.encode_inverse(iprogs, isch, [inv_block] * levels, compute)
    x = torch.from_numpy(_image(shape, seed=seed)).to(io)
    ll, details = PW.pyramid_forward_ref(fwd, x)
    want = [ll] + [d for det in details for d in det]
    got = emulate_forward(fwd, x.float().numpy(), io)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g, wt.float().numpy())
    rec = PW.pyramid_inverse_ref(inv, ll, details)
    got = emulate_inverse(inv, [t.float().numpy() for t in want], io)
    np.testing.assert_array_equal(got, rec.float().numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("wavelet", WAVELETS)
def test_encoded_pyramid_tables_match_plain_versions(wavelet, scheme):
    """Ragged multi-tile planes (edge tiles past the plane, wrap on every
    side; at three levels the coarsest 5x7 planes are smaller than a
    tile) at levels 1-3, tap_opt full and off."""
    for levels, tap_opt in itertools.product((1, 2, 3), ("full", "off")):
        inv_block = (4, 8) if levels < 3 else (8, 8)
        _emulation_case(wavelet, scheme, levels, tap_opt, inv_block,
                        (2, 40, 56), seed=levels)


@pytest.mark.parametrize("io,compute", [(torch.float16, "float32"),
                                        (torch.bfloat16, "float32"),
                                        (torch.float32, "bfloat16"),
                                        (torch.float16, "bfloat16")])
def test_encoded_pyramid_tables_narrow_types(io, compute):
    """Half-precision I/O rounds LL through the I/O dtype between levels;
    bfloat16 compute rounds every product and sum."""
    for scheme in ("ns-polyconv", "sep-lifting"):
        _emulation_case("cdf97", scheme, 3, "full", (8, 16), (2, 48, 72),
                        io=io, compute=compute, seed=11)


def test_encoded_pyramid_main_path_block():
    """The main path's tiles and programs (both kernels at the (32, 32)
    plane tile of every level) on a 1x128x320 image (several tiles, one
    ragged column of tiles at every level)."""
    _emulation_case("cdf97", "ns-polyconv", 3, "full", (32, 32),
                    (1, 128, 320), seed=12, fwd_block=(32, 32))


# ---------------------------------------------------------------------------
# wrappers, and the float row mapping the kernels share
# ---------------------------------------------------------------------------

def test_wrappers_check_and_cpu_path_does_not_count():
    spec = _kernels("cdf53", "ns-conv", 2)
    fwd, inv = spec.fwd_kernel, spec.inv_kernel
    before = (PW.FORWARD.launches, PW.INVERSE.launches)
    x = torch.randn(2, 16, 24)
    ll, det = PW.pyramid_forward(fwd, x)
    PW.pyramid_inverse(inv, ll, det)
    assert (PW.FORWARD.launches, PW.INVERSE.launches) == before
    with pytest.raises(ValueError, match="not divisible"):
        PW.pyramid_forward(fwd, torch.randn(1, 10, 16))
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        PW.pyramid_forward(fwd, torch.randn(16, 16))
    with pytest.raises(TypeError, match="unsupported"):
        PW.pyramid_forward(fwd, x.double())
    with pytest.raises(ValueError, match="inverse pyramid table"):
        PW.pyramid_forward(inv, x)
    with pytest.raises(ValueError, match="pyramid_inverse takes"):
        PW.pyramid_inverse(inv, ll, det[::-1])
    with pytest.raises(ValueError, match="level blocks"):
        PW.encode_inverse(inv.programs, inv.sched, inv.level_blocks[:1])
    with pytest.raises(ValueError, match="forward schedule"):
        PW.encode_inverse(inv.programs, fwd.sched, inv.level_blocks)
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        PW.encode_inverse(inv.programs, inv.sched, inv.level_blocks,
                          "float16")
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        PW.encode_forward(fwd.programs, fwd.sched, fwd.level_blocks,
                          "float16")
    with pytest.raises(ValueError, match="level blocks"):
        PW.encode_forward(fwd.programs, fwd.sched, fwd.level_blocks[:1])


def test_row_formula_is_exact_for_every_window():
    """``row_of``: floor((i + 0.5) * fl(1 / w)) in float32 equals i // w
    for every width up to MAX_WINDOW_WIDTH at every index a window of at
    most MAX_WINDOW_ELEMS positions holds."""
    i = np.arange(TW.MAX_WINDOW_ELEMS, dtype=np.int64)
    fi = i.astype(np.float32) + np.float32(0.5)
    for w in range(1, TW.MAX_WINDOW_WIDTH + 1):
        inv = np.float32(1.0) / np.float32(w)
        rows = np.floor(fi * inv).astype(np.int64)
        assert np.array_equal(rows, i // w), w


def test_guards_keep_windows_inside_the_row_bounds():
    """Every window either guard admits at its largest block fits the
    bounds the row formula is checked for, and the encoders refuse
    windows past them."""
    for w, s, opt, inv, lvl in itertools.product(
            WAVELETS, SCHEMES, (False, True), (False, True), OPT_LEVELS):
        for prog in TC.compile_scheme_programs(w, s, opt, inv, lvl,
                                               "none") + \
                TC.compile_scheme_programs(w, s, opt, inv, lvl, "scheme"):
            wh, ww = (e + 2 * prog.halo for e in TW.BLOCK_TARGET)
            assert ww <= TW.MAX_WINDOW_WIDTH
            assert wh * ww <= TW.MAX_WINDOW_ELEMS
    for s, levels in itertools.product(SCHEMES, range(1, 6)):
        spec = _kernels("dd137", s, levels)
        if spec is None:
            continue
        windows = [(bh + 2 * p.halo, bw + 2 * p.halo)
                   for pw in (spec.fwd_kernel, spec.inv_kernel)
                   for p, (bh, bw) in zip(pw.programs, pw.level_blocks)]
        for wh, ww in windows:
            assert ww <= TW.MAX_WINDOW_WIDTH
            assert wh * ww <= TW.MAX_WINDOW_ELEMS
    prog = TC.compile_scheme_programs("cdf97", "ns-polyconv", False, False,
                                      "full", "scheme")[0]
    with pytest.raises(ValueError, match="exceeds the kernels' bounds"):
        TW.encode(prog, (256, 256))
    spec = _kernels("cdf97", "ns-polyconv", 1)
    with pytest.raises(ValueError, match="exceeds the kernels' bounds"):
        PW.encode_inverse(spec.inv_kernel.programs, spec.inv_sched,
                          [(4, 1024)])
    with pytest.raises(ValueError, match="exceeds the kernels' bounds"):
        PW.encode_forward(spec.fwd_kernel.programs, spec.fwd_sched,
                          [(4, 1024)])


@pytest.mark.parametrize("scheme", ("ns-polyconv", "sep-lifting"))
def test_one_level_pyramid_does_the_window_kernels_work(scheme):
    """At one level each pyramid kernel's window is K1's: the same term
    evaluations per image at its plane block, and the same table."""
    spec = _kernels("cdf97", scheme, 1)
    for pw in (spec.fwd_kernel, spec.inv_kernel):
        win = TW.encode(pw.programs[0], pw.level_blocks[0])
        assert pw.term_evaluations((2, 256, 512)) == \
            win.term_evaluations((2, 128, 256))
        np.testing.assert_array_equal(_levels_of(pw)[0][0], win.table)
