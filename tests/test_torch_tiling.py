"""Tiling and streaming on the port, against the reference package.

Mirrors tests/test_tiling.py and the streaming cases of
tests/test_resilience.py on ``repro_torch`` (CPU, small sizes):

* grids, margins and window indices equal the reference's exactly, for
  every scheme x wavelet x levels x tap_opt on the three backend pairs
  (``"torch"``/``"cuda"``/``"conv"`` against ``"jnp"``/``"pallas"``/
  ``"xla"``);
* tiled ``dwt2``/``idwt2`` on ``"torch"`` (and ``"cuda"``, which runs
  the kernels' plain versions on CPU tensors) bit-identical to the
  port's monolithic transform, and within ``CROSS_TOL`` of the
  reference's tiled ``"jnp"`` (and of its interpret-mode Pallas);
* plan caching, ``engine.stats()`` rows, the launch and bytes models of
  a tiled plan, its spans and its ``tiling.halo_gather`` fault site;
* ``stream_dwt2`` on a memmapped image, non-dividing tiles, every
  ``max_inflight``, the float64 decision; the band checkpoint (kill and
  resume, mismatch, torn journal, a journal the reference wrote) and
  the retry rules (fault-plane errors retried, a device error not);
* the ``"dist"`` transport over ``torch.distributed`` (gloo, four CPU
  processes) on a 2x2 and a 1x4 rank mesh, forward and inverse.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core import transform as JT
from repro.core.schemes import SCHEMES
from repro.tiling import exchange as JEX
from repro.tiling import open_checkpoint as j_open_checkpoint
from repro.tiling import stream_dwt2 as j_stream_dwt2

import repro_torch as R
from repro_torch import engine as TE
from repro_torch import telemetry as T
from repro_torch.faults import inject as FJ
from repro_torch.faults import plan as FP
from repro_torch.faults.policy import RETRIES
from repro_torch.tiling import (CheckpointMismatch, TileGrid,
                                open_checkpoint, pyramid_margin,
                                stream_dwt2, validate_geometry)
from repro_torch.tiling import api as TA
from repro_torch.tiling import exchange as EX
from repro_torch.tiling import stream as ST

ROOT = Path(__file__).resolve().parents[1]
# tests/test_differential.py CROSS_TOL / ROUNDTRIP_TOL (float32)
CROSS_TOL = dict(rtol=2e-4, atol=2e-5)
ROUNDTRIP_TOL = dict(rtol=1e-3, atol=1e-4)
WAVELETS = ("cdf53", "cdf97", "dd137")
PAIRS = (("torch", "jnp"), ("cuda", "pallas"), ("conv", "xla"))


@pytest.fixture(autouse=True)
def _port_planes():
    """The port's telemetry and fault planes, isolated per test (the
    reference's are isolated by tests/conftest.py)."""
    prev_mode = T.mode()
    prev_plan = FJ.activate(None)
    T.set_mode("counters")
    T.reset()
    yield
    FJ.activate(prev_plan)
    T.set_mode(prev_mode)
    T.reset()


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(pyr):
    return [pyr.ll] + [s for det in pyr.details for s in det]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_pyr_equal(a, b):
    for pa, pb in zip(_flat(a), _flat(b), strict=True):
        assert tuple(pa.shape) == tuple(pb.shape)
        np.testing.assert_array_equal(_np(pa), _np(pb))


def _assert_pyr_close(a, b, tol=CROSS_TOL):
    for pa, pb in zip(_flat(a), _flat(b), strict=True):
        assert tuple(pa.shape) == tuple(pb.shape)
        np.testing.assert_allclose(_np(pa), _np(pb), **tol)


def _cpu(**kw):
    return dict(kw, device="cpu")


# ---------------------------------------------------------------------------
# Grids, margins and window indices: exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("port,ref", PAIRS)
def test_grid_and_margins_equal_reference(port, ref, scheme):
    """3 wavelets x levels 1-3 x tap_opt x fuse none/levels: the port's
    tiled grid equals the reference's, margin for margin."""
    for wavelet in WAVELETS:
        for levels in (1, 2, 3):
            for tap_opt in ("off", "exact", "full"):
                for fuse in ("none", "levels"):
                    kw = dict(wavelet=wavelet, scheme=scheme,
                              levels=levels, shape=(128, 192),
                              dtype="float32", fuse=fuse, tap_opt=tap_opt,
                              tiles=(64, 64))
                    want = JE.get_plan(backend=ref, cache=JE.PlanCache(),
                                       **kw).grid
                    got = TE.get_plan(backend=port, device="cpu",
                                      cache=TE.PlanCache(), **kw).grid
                    assert got.describe() == want.describe(), kw
                    assert got == TileGrid(**vars(want)), kw


@pytest.mark.parametrize("n_tiles,core,margin,period",
                         [(3, 48, 12, 116), (4, 16, 32, 64), (6, 384, 64,
                                                              2048)])
def test_window_indices_equal_reference(n_tiles, core, margin, period):
    got = EX.window_indices(n_tiles, core, margin, period)
    np.testing.assert_array_equal(
        got, JEX.window_indices(n_tiles, core, margin, period))


def test_gather_and_stitch_shapes_and_contents():
    """The broadcast gather yields ``(..., T, wh, ww)``, equal to the
    reference's numpy gather; laying the windows' untransformed cores
    out on the grid gives the image back, as a contiguous tensor."""
    x = _rand((2, 100, 120), seed=1)
    g = TileGrid(image_shape=(100, 120), tile=(48, 48), levels=2,
                 margin=8, inv_margin=12)
    wins = EX.gather_windows(torch.from_numpy(x), g)
    assert tuple(wins.shape) == (2, 9, 64, 64)
    ri = JEX.window_indices(3, 48, 8, 100)
    ci = JEX.window_indices(3, 48, 8, 120)
    want = x[..., ri[:, None, :, None], ci[None, :, None, :]]
    np.testing.assert_array_equal(wins.numpy(), want.reshape(2, 9, 64, 64))
    img = EX._assemble(wins[..., 8:56, 8:56], g, (100, 120))
    np.testing.assert_array_equal(img.numpy(), x)
    assert img.is_contiguous()


def test_pyramid_margin_formula():
    assert pyramid_margin([2], 1) == 4
    assert pyramid_margin([2, 2, 2], 3) == 32   # 28 aligned up to 8
    assert pyramid_margin([1, 1], 2) == 8       # 6 aligned up to 4


def test_grid_geometry():
    g = TileGrid(image_shape=(100, 120), tile=(48, 48), levels=2,
                 margin=8, inv_margin=12)
    assert g.grid_shape == (3, 3)
    assert g.count == 9
    assert g.window_shape == (64, 64)
    assert g.inv_window_shape == (72, 72)
    assert g.describe()["tiles"] == 9


# ---------------------------------------------------------------------------
# Tiled == monolithic, bit for bit; the reference within CROSS_TOL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tap_opt", ("off", "exact", "full"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tiled_bit_identical_torch(scheme, tap_opt):
    """All 6 schemes x tap_opt, odd/prime plane factors (116 = 4*29,
    124 = 4*31) and a non-dividing 48x48 tile, forward and inverse."""
    x = _rand((116, 124), seed=1)
    kw = _cpu(wavelet="cdf97", levels=2, scheme=scheme, tap_opt=tap_opt,
              backend="torch")
    mono = R.dwt2(torch.from_numpy(x), **kw)
    tiled = R.dwt2(torch.from_numpy(x), tiles=(48, 48), **kw)
    _assert_pyr_equal(mono, tiled)
    ikw = {k: v for k, v in kw.items() if k != "levels"}
    xm = R.idwt2(mono, **ikw)
    xt = R.idwt2(mono, tiles=(48, 48), **ikw)
    np.testing.assert_array_equal(xm.numpy(), xt.numpy())
    ref = JT.dwt2(x, wavelet="cdf97", levels=2, scheme=scheme,
                  tap_opt=tap_opt, backend="jnp", tiles=(48, 48))
    _assert_pyr_close(tiled, ref)


@pytest.mark.parametrize("tiles", ((16, 16), (32, 48), (48, 16)))
def test_tiled_bit_identical_tile_sizes(tiles):
    """Dividing and non-dividing tile shapes, 3 levels, dd137 (the
    widest halo), on "torch" and on "cuda"'s plain versions; the
    reference's monolithic transform, which its own tests hold equal to
    its tiled one, within CROSS_TOL."""
    x = _rand((96, 112), seed=2)
    for backend in ("torch", "cuda"):
        kw = _cpu(wavelet="dd137", levels=3, scheme="ns-polyconv",
                  backend=backend)
        mono = R.dwt2(torch.from_numpy(x), **kw)
        tiled = R.dwt2(torch.from_numpy(x), tiles=tiles, **kw)
        _assert_pyr_equal(mono, tiled)
    ref = JT.dwt2(x, wavelet="dd137", levels=3, scheme="ns-polyconv")
    _assert_pyr_close(tiled, ref)


def test_tiled_batched_and_optimized():
    """Batched (B, C, H, W) input and the Section-5 optimized split both
    ride through the tiled path unchanged."""
    x = _rand((2, 3, 64, 64), seed=3)
    kw = _cpu(wavelet="cdf97", levels=2, scheme="sep-lifting",
              optimize=True, backend="torch")
    mono = R.dwt2(torch.from_numpy(x), **kw)
    tiled = R.dwt2(torch.from_numpy(x), tiles=(32, 32), **kw)
    _assert_pyr_equal(mono, tiled)
    xr = R.idwt2(tiled, wavelet="cdf97", scheme="sep-lifting",
                 tiles=(32, 32), backend="torch", device="cpu")
    np.testing.assert_allclose(xr.numpy(), x, **ROUNDTRIP_TOL)


def test_tiled_cuda_matches_reference_pallas():
    """The reference's interpret-mode Pallas, tiled, against the port's
    "cuda" tiled path (the kernels' plain versions on the CPU)."""
    scheme = "ns-polyconv"
    x = _rand((64, 96), seed=4)
    kw = dict(wavelet="cdf97", levels=2, scheme=scheme, tap_opt="exact")
    ref = JT.dwt2(x, backend="pallas", tiles=(32, 32), **kw)
    got = R.dwt2(torch.from_numpy(x), backend="cuda", tiles=(32, 32),
                 device="cpu", **kw)
    _assert_pyr_close(got, ref)
    mono = R.dwt2(torch.from_numpy(x), backend="cuda", device="cpu", **kw)
    _assert_pyr_equal(mono, got)
    ikw = dict(wavelet="cdf97", scheme=scheme, tap_opt="exact",
               backend="cuda", device="cpu")
    xr = R.idwt2(got, tiles=(32, 32), **ikw)
    np.testing.assert_array_equal(xr.numpy(), R.idwt2(got, **ikw).numpy())
    np.testing.assert_allclose(xr.numpy(), x, **ROUNDTRIP_TOL)


def test_tiled_conv_backend():
    """The conv backend tiles like the reference's "xla": within
    CROSS_TOL of it and of the port's monolithic conv transform
    (F.conv2d's rounding follows the plane shape, so not bit for bit)."""
    x = _rand((2, 64, 96), seed=5)
    kw = dict(wavelet="cdf97", levels=2, scheme="sep-lifting",
              fuse="levels")
    got = R.dwt2(torch.from_numpy(x), backend="conv", tiles=(32, 32),
                 device="cpu", **kw)
    mono = R.dwt2(torch.from_numpy(x), backend="conv", device="cpu", **kw)
    _assert_pyr_close(got, mono)
    _assert_pyr_close(got, JT.dwt2(x, backend="xla", tiles=(32, 32), **kw))
    xr = R.idwt2(got, wavelet="cdf97", scheme="sep-lifting", fuse="levels",
                 backend="conv", tiles=(32, 32), device="cpu")
    np.testing.assert_allclose(xr.numpy(), x, **ROUNDTRIP_TOL)


def test_tiled_pyramid_runs_the_window_plans_pyramid():
    """fuse="pyramid" on "cuda": the outer tiled plan resolves no
    pyramid, its window plan does (one K2 / K3 launch for the whole
    grid); the result equals the monolithic "levels" transform bit for
    bit (the plain versions) and the reference's tiled "jnp"."""
    x = _rand((64, 64), seed=6)
    kw = _cpu(wavelet="cdf97", levels=2, scheme="ns-polyconv",
              backend="cuda")
    plan = TE.get_plan(shape=x.shape, fuse="pyramid", tiles=(32, 32), **kw)
    assert plan.pyramid is None and plan.tile_count == 4
    wplan = TA.window_plan(plan, "forward")
    assert wplan.pyramid is not None and plan.launches == 1
    assert TA.window_plan(plan, "inverse").pyramid is not None
    got = R.dwt2(torch.from_numpy(x), fuse="pyramid", tiles=(32, 32), **kw)
    lvl = R.dwt2(torch.from_numpy(x), fuse="levels", **kw)
    _assert_pyr_equal(got, lvl)
    _assert_pyr_close(got, JT.dwt2(x, wavelet="cdf97", levels=2,
                                   tiles=(32, 32)))
    ikw = {k: v for k, v in kw.items() if k != "levels"}
    rec = R.idwt2(got, fuse="pyramid", tiles=(32, 32), **ikw)
    np.testing.assert_array_equal(
        rec.numpy(), R.idwt2(got, fuse="levels", **ikw).numpy())


@pytest.mark.parametrize("fuse,launches", [("none", 4), ("levels", 2),
                                           ("pyramid", 1)])
def test_tiled_plan_launches_are_the_window_plans(fuse, launches):
    plan = TE.get_plan(shape=(2, 64, 64), levels=2, backend="cuda",
                       fuse=fuse, tiles=(32, 32), device="cpu",
                       cache=TE.PlanCache())
    assert plan.launches == launches
    assert plan.launches == TA.window_plan(plan, "forward").launches


def test_tiled_hbm_bytes_model():
    """Window plan bytes + gather (image read, windows written) + stitch
    (cores read, planes written), for both directions."""
    plan = TE.get_plan(shape=(2, 100, 120), levels=2, backend="cuda",
                       fuse="levels", tiles=(48, 48), device="cpu",
                       cache=TE.PlanCache())
    g = plan.grid
    image, cores = 2 * 100 * 120, 2 * 9 * 48 * 48
    wh, ww = g.window_shape
    fwd = TA.window_plan(plan, "forward").executor.hbm_bytes("forward")
    assert plan.executor.hbm_bytes("forward") == fwd + 4 * (
        image + 2 * 9 * wh * ww + cores + image)
    mi = g.inv_margin
    win = [(48 >> (l + 1)) + 2 * (mi >> (l + 1)) for l in range(2)]
    per_tile = 3 * win[0] ** 2 + 3 * win[1] ** 2 + win[1] ** 2
    inv = TA.window_plan(plan, "inverse").executor.hbm_bytes("inverse")
    assert plan.executor.hbm_bytes("inverse") == inv + 4 * (
        image + 2 * 9 * per_tile + cores + image)


# ---------------------------------------------------------------------------
# Geometry validation (the reference's error texts)
# ---------------------------------------------------------------------------

def test_validate_levels_names_dimension_and_max_feasible():
    with pytest.raises(ValueError, match=r"W=48.*max feasible levels.*is 4"):
        validate_geometry(64, 48, 5)
    with pytest.raises(ValueError, match=r"H=20"):
        validate_geometry(20, 64, 3)
    validate_geometry(64, 48, 4)
    validate_geometry(64, 64, 2, tiles=(32, 32))


def test_validate_tile_alignment():
    with pytest.raises(ValueError, match=r"tile H=24.*2\^levels=16"):
        validate_geometry(64, 64, 4, tiles=(24, 32))
    with pytest.raises(ValueError, match="positive"):
        validate_geometry(64, 64, 1, tiles=(0, 32))
    with pytest.raises(ValueError) as err:
        validate_geometry(64, 96, 3, tiles=(20, 32))
    from repro.tiling import validate_geometry as j_validate
    with pytest.raises(ValueError) as want:
        j_validate(64, 96, 3, tiles=(20, 32))
    assert str(err.value) == str(want.value)


def test_dwt2_surfaces_validation_errors():
    x = torch.from_numpy(_rand((64, 96), seed=6))
    kw = _cpu(backend="torch")
    with pytest.raises(ValueError, match="max feasible levels"):
        R.dwt2(x, levels=6, **kw)
    with pytest.raises(ValueError, match="tile"):
        R.dwt2(x, levels=3, tiles=(20, 32), **kw)
    # oversized tiles clamp to the image instead of erroring
    _assert_pyr_equal(R.dwt2(x, levels=2, **kw),
                      R.dwt2(x, levels=2, tiles=(256, 256), **kw))


# ---------------------------------------------------------------------------
# Plan caching, engine stats, spans, the halo-gather fault site
# ---------------------------------------------------------------------------

def test_tiled_plans_cached_like_monolithic():
    TE.clear_plan_cache()
    x = torch.from_numpy(_rand((64, 64), seed=7))
    kw = _cpu(levels=2, tiles=(32, 32), backend="torch")
    R.dwt2(x, **kw)
    before = TE.plan_cache_stats()
    R.dwt2(x, **kw)
    after = TE.plan_cache_stats()
    # the tiled plan and its window plan both hit, nothing is rebuilt
    assert after["hits"] == before["hits"] + 2
    assert after["misses"] == before["misses"]
    R.dwt2(x, **dict(kw, tiles=(16, 16)))   # another tiling, another plan
    assert TE.plan_cache_stats()["misses"] > after["misses"]


def test_engine_stats_tiled_rows_equal_reference():
    x = _rand((64, 64), seed=8)
    JE.clear_plan_cache()
    JT.dwt2(x, levels=2, tiles=(32, 32))
    want = [r for r in JE.stats()["plans"] if r.get("tiles")]
    TE.clear_plan_cache()
    R.dwt2(torch.from_numpy(x), levels=2, tiles=(32, 32), backend="torch",
           device="cpu")
    st = TE.stats()
    got = [r for r in st["plans"] if r.get("tiles")]
    assert len(got) == len(want) == 1
    keys = ("tiles", "tile_count", "tile_grid", "halo_margin")
    assert {k: got[0][k] for k in keys} == {k: want[0][k] for k in keys}
    assert got[0]["tile_count"] == 4 and got[0]["tile_grid"] == (2, 2)
    assert got[0]["halo_margin"] > 0
    assert any("compiled_macs" in r for r in st["plans"])


def test_tiled_spans_nest_under_execute():
    T.set_mode("spans")
    x = torch.from_numpy(_rand((64, 64), seed=9))
    pyr = R.dwt2(x, levels=2, tiles=(32, 32), backend="cuda", device="cpu")
    R.idwt2(pyr, tiles=(32, 32), backend="cuda", device="cpu")
    recs = T.TRACER.records()
    by_id = {r.span_id: r for r in recs}
    for op in ("forward", "inverse"):
        names = [r.name for r in recs if r.labels.get("op") == op
                 and r.name.startswith("tile.")]
        assert names == ["tile.halo_gather", "tile.window_transform",
                         "tile.stitch"], names
        for r in recs:
            if r.name.startswith("tile.") and r.labels["op"] == op:
                assert by_id[r.parent_id].name == f"execute.{op}"


def test_halo_gather_fault_is_retried_and_clean():
    x = torch.from_numpy(_rand((2, 64, 64), seed=10))
    kw = _cpu(levels=2, tiles=(32, 32), backend="cuda", fuse="pyramid")
    clean = R.dwt2(x, **kw)
    FJ.activate(FP.FaultPlan.from_text("tiling.halo_gather=raise:once"))
    got = R.dwt2(x, **kw)
    FJ.activate(None)
    _assert_pyr_equal(clean, got)
    assert sum(r["value"] for r in RETRIES.series()) == 1
    assert TE.stats()["faults"]["fallbacks"] == 0


# ---------------------------------------------------------------------------
# Streaming executor (out-of-core)
# ---------------------------------------------------------------------------

def test_stream_memmapped_image_bit_identical(tmp_path):
    """A 1024x1536 memmapped image streamed band by band: bit-identical
    to the port's monolithic "torch" transform, and within CROSS_TOL of
    the reference's stream."""
    h, w = 1024, 1536
    path = tmp_path / "big.f32"
    disk = np.memmap(path, dtype=np.float32, mode="w+", shape=(h, w))
    disk[:] = _rand((h, w), seed=9)
    disk.flush()
    img = np.memmap(path, dtype=np.float32, mode="r", shape=(h, w))
    kw = dict(wavelet="cdf97", levels=3, scheme="ns-polyconv",
              tiles=(256, 256))
    pyr = stream_dwt2(img, fuse="none", backend="torch", device="cpu", **kw)
    assert isinstance(pyr.ll, np.ndarray)       # host-resident output
    mono = R.dwt2(torch.from_numpy(np.array(img)), wavelet="cdf97",
                  levels=3, backend="torch", device="cpu")
    _assert_pyr_equal(mono, pyr)
    _assert_pyr_close(pyr, j_stream_dwt2(img, fuse="none", **kw))


@pytest.mark.parametrize("backend", ("torch", "cuda"))
def test_stream_non_dividing_and_inflight(backend):
    x = _rand((192, 160), seed=10)
    kw = _cpu(wavelet="cdf53", levels=2, scheme="sep-conv",
              backend=backend)
    mono = R.dwt2(torch.from_numpy(x), **kw)
    for inflight in (1, 2, 3):
        pyr = stream_dwt2(x, tiles=(64, 64), fuse="none",
                          max_inflight=inflight, **kw)
        _assert_pyr_equal(mono, pyr)
    with pytest.raises(ValueError, match="max_inflight"):
        stream_dwt2(x, levels=1, tiles=(64, 64), max_inflight=0,
                    backend=backend, device="cpu")
    with pytest.raises(ValueError, match="single"):
        stream_dwt2(x[None], levels=1, tiles=(64, 64), backend=backend,
                    device="cpu")


def test_stream_float64_runs_on_torch_and_is_refused_on_cuda():
    x = _rand((128, 128), seed=11).astype(np.float64)
    pyr = stream_dwt2(x, levels=2, tiles=(64, 64), backend="torch",
                      device="cpu")
    assert pyr.ll.dtype == np.float64
    _assert_pyr_equal(R.dwt2(torch.from_numpy(x), levels=2,
                             backend="torch", device="cpu"), pyr)
    with pytest.raises(TE.BackendError, match="PlanKey.dtype"):
        stream_dwt2(x, levels=2, tiles=(64, 64), backend="cuda",
                    device="cpu")


def _stream_kw():
    return dict(levels=2, tiles=(32, 32), backend="torch", fuse="none",
                device="cpu")


def test_stream_checkpoint_resume_recomputes_unjournaled_bands(tmp_path):
    img = np.arange(128.0 * 128, dtype=np.float32).reshape(128, 128)
    ref = stream_dwt2(img, **_stream_kw())
    ck = str(tmp_path / "ck")
    pyr = stream_dwt2(img, checkpoint=ck, **_stream_kw())
    assert np.array_equal(pyr.ll, ref.ll)

    # a kill after band 1: the journal truncated to 2 records, the
    # unjournaled bands' rows poisoned — resume trusts only the journal
    jp = os.path.join(ck, "journal.jsonl")
    lines = open(jp).read().splitlines()
    assert len(lines) == 4                      # 4 bands of 32 rows
    with open(jp, "w") as f:
        f.write("\n".join(lines[:2]) + "\n")
    man = json.load(open(os.path.join(ck, "manifest.json")))["config"]
    ck2 = open_checkpoint(ck, man)
    assert ck2.completed == {0, 1} and not ck2.complete
    ck2.ll[16:] = -777.0                        # bands 2-3 ll rows poisoned
    ck2.ll.flush()

    pyr2 = stream_dwt2(img, checkpoint=ck, **_stream_kw())
    _assert_pyr_equal(ref, pyr2)


def test_stream_checkpoint_mismatch_and_torn_journal(tmp_path):
    img = np.zeros((128, 128), np.float32)
    ck = str(tmp_path / "ck")
    stream_dwt2(img, checkpoint=ck, **_stream_kw())
    with pytest.raises(CheckpointMismatch, match="levels"):
        stream_dwt2(img, checkpoint=ck, **dict(_stream_kw(), levels=1))
    with open(os.path.join(ck, "journal.jsonl"), "a") as f:
        f.write('{"band": 2, "crc": 1}\n')     # checksum-invalid record
        f.write('{"band": 3, "cr')             # torn tail
    man = json.load(open(os.path.join(ck, "manifest.json")))["config"]
    ck2 = open_checkpoint(ck, man)
    assert ck2.stats()["torn_records"] == 2
    assert ck2.completed == {0, 1, 2, 3}       # the valid prefix


def test_stream_retries_ride_transient_band_faults():
    img = np.arange(128.0 * 128, dtype=np.float32).reshape(128, 128)
    ref = stream_dwt2(img, **_stream_kw())
    # a seed under which both sites fire (seed 11 of the reference's
    # test fires neither on these four bands)
    FJ.activate(FP.FaultPlan.from_text(
        "stream.host_gather=0.3,stream.drain=0.3", seed=3))
    pyr = stream_dwt2(img, retries=4, **_stream_kw())
    fired = FJ.stats()["plan"]["sites"]
    FJ.activate(None)
    _assert_pyr_equal(ref, pyr)
    assert fired["stream.host_gather"]["fired"] > 0
    assert fired["stream.drain"]["fired"] > 0
    assert sum(r["value"] for r in RETRIES.series()) > 0
    FJ.activate(FP.FaultPlan.from_text("stream.h2d_dispatch=once", seed=1))
    with pytest.raises(FJ.InjectedFault):       # retries=0: fail fast
        stream_dwt2(img, **_stream_kw())


def test_journal_written_by_the_reference_reads_back(tmp_path):
    """The manifest / journal / checksum format is the reference's: a
    checkpoint its stream wrote opens in the port with the same
    completed set and torn count, and the port's records are byte for
    byte the reference's."""
    img = np.arange(128.0 * 128, dtype=np.float32).reshape(128, 128)
    ck = str(tmp_path / "ck")
    j_stream_dwt2(img, checkpoint=ck, levels=2, tiles=(32, 32),
                  backend="jnp", fuse="none")
    with open(os.path.join(ck, "journal.jsonl"), "a") as f:
        f.write('{"band": 9, "cr')             # torn tail
    man = json.load(open(os.path.join(ck, "manifest.json")))["config"]
    want = j_open_checkpoint(ck, man)
    got = open_checkpoint(ck, man)
    assert got.completed == want.completed == {0, 1, 2, 3}
    assert got.stats()["torn_records"] == want.stats()["torn_records"] == 1
    np.testing.assert_array_equal(got.ll, want.ll)
    from repro.tiling import checkpoint as JCK
    from repro_torch.tiling import checkpoint as CK
    assert CK._record(7) == JCK._record(7)


def test_device_error_in_a_band_is_not_retried(monkeypatch):
    """On the "cuda" backend only the fault plane's own errors are
    retried: a CUDA error raised in a band's drain propagates as it is,
    with no retry counted."""
    real = FJ.maybe_inject

    def fake(site, **ctx):
        if site == "stream.drain":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return real(site, **ctx)

    monkeypatch.setattr(ST.FI, "maybe_inject", fake)
    img = np.zeros((64, 64), np.float32)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        stream_dwt2(img, levels=1, tiles=(32, 32), backend="cuda",
                    device="cpu", retries=3)
    assert sum(r["value"] for r in RETRIES.series()) == 0
    # the torch backend on the CPU retries any host-side failure
    with pytest.raises(RuntimeError, match="illegal memory access"):
        stream_dwt2(img, levels=1, tiles=(32, 32), backend="torch",
                    device="cpu", retries=3)
    assert sum(r["value"] for r in RETRIES.series()) > 0


# ---------------------------------------------------------------------------
# dist transport (torch.distributed, gloo, four CPU processes)
# ---------------------------------------------------------------------------

_DIST_WORKER = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ((2, 2, (64, 64), (32, 32)), (1, 4, (32, 128), (32, 32)))


def run(rank, world, out):
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "rendezvous"), rank=rank, world_size=world)
    try:
        import repro_torch as R
        from repro_torch.distributed.sharding import TileMesh
        for k, (rows, cols, shape, (th, tw)) in enumerate(CASES):
            mesh = TileMesh(rows, cols)
            x = np.random.default_rng(3).standard_normal(shape).astype(
                np.float32)
            r, c = mesh.coords(mesh.rank)
            block = torch.from_numpy(
                x[r * th:(r + 1) * th, c * tw:(c + 1) * tw].copy())
            kw = dict(wavelet="cdf97", scheme="ns-polyconv",
                      tiles=(th, tw), backend="torch", device="cpu",
                      transport="dist", mesh=mesh)
            pyr = R.dwt2_tiled(block, levels=2, **kw)
            rec = R.idwt2_tiled(pyr, **kw)
            planes = [pyr.ll] + [d for det in pyr.details for d in det]
            np.savez(os.path.join(out, f"case{k}_rank{rank}.npz"),
                     rec=rec.numpy(), *[p.numpy() for p in planes])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4)
"""


def test_dist_transport_matches_gather_on_2x2_and_1x4(tmp_path):
    """Four gloo processes, one tile block each: on a 2x2 mesh (up and
    down neighbours are one rank) and a 1x4 mesh (the row neighbour is
    the rank itself), forward and inverse, equal bit for bit to the
    gather transport's blocks and within CROSS_TOL of the reference's
    monolithic "jnp"."""
    script = tmp_path / "dist_worker.py"
    script.write_text(_DIST_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    for k, (rows, cols, shape, (th, tw)) in enumerate(
            ((2, 2, (64, 64), (32, 32)), (1, 4, (32, 128), (32, 32)))):
        x = np.random.default_rng(3).standard_normal(shape).astype(
            np.float32)
        kw = _cpu(wavelet="cdf97", scheme="ns-polyconv", tiles=(th, tw),
                  backend="torch")
        gather = R.dwt2_tiled(torch.from_numpy(x), levels=2, **kw)
        rec = R.idwt2_tiled(gather, **kw).numpy()
        ref = JT.dwt2(x, wavelet="cdf97", levels=2, scheme="ns-polyconv")
        for rank in range(4):
            got = np.load(tmp_path / f"case{k}_rank{rank}.npz")
            r, c = divmod(rank, cols)
            for j, (p, q) in enumerate(zip(_flat(gather), _flat(ref))):
                blk = got[f"arr_{j}"]
                bh, bw = blk.shape
                sl = np.s_[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw]
                np.testing.assert_array_equal(blk, p.numpy()[sl])
                np.testing.assert_allclose(blk, np.asarray(q)[sl],
                                           **CROSS_TOL)
            sl = np.s_[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
            np.testing.assert_array_equal(got["rec"], rec[sl])
            np.testing.assert_allclose(got["rec"], x[sl], **ROUNDTRIP_TOL)


def test_dist_preconditions():
    class FakeMesh:
        rows, cols = 2, 2

    g = TileGrid(image_shape=(128, 120), tile=(64, 48), levels=1,
                 margin=8, inv_margin=8)
    with pytest.raises(ValueError, match="evenly"):
        EX.validate_shard_grid(g, FakeMesh())
    g2 = TileGrid(image_shape=(128, 128), tile=(64, 64), levels=1,
                  margin=8, inv_margin=8)

    class WideMesh:
        rows, cols = 1, 4

    with pytest.raises(ValueError, match="mesh axis"):
        EX.validate_shard_grid(g2, WideMesh())
    g3 = TileGrid(image_shape=(128, 128), tile=(64, 64), levels=1,
                  margin=96, inv_margin=8)
    with pytest.raises(ValueError, match="single-hop"):
        EX.validate_shard_grid(g3, FakeMesh())
    EX.validate_shard_grid(g3, FakeMesh(), inverse=True)   # passes
    EX.validate_shard_grid(g2, FakeMesh())                 # passes

    x = torch.from_numpy(_rand((64, 64)))
    with pytest.raises(ValueError, match="mesh"):
        R.dwt2_tiled(x, tiles=(32, 32), transport="dist", device="cpu")
    with pytest.raises(ValueError, match="'dist'"):
        R.dwt2_tiled(x, tiles=(32, 32), transport="shard_map", device="cpu")
    with pytest.raises(ValueError, match="transport"):
        R.dwt2_tiled(x, tiles=(32, 32), transport="rdma", device="cpu")


def test_tile_mesh_maps_ranks_and_checks_the_world(tmp_path):
    import torch.distributed as dist
    from repro_torch.distributed.sharding import TileMesh
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "rdv"), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 devices, have 1"):
            TileMesh(2, 2)
        mesh = TileMesh(1, 1)
        assert mesh.coords(0) == (0, 0) and mesh.rank_of(0, 0) == 0
        # an axis of 1: the neighbour is the rank itself, wrapped locally
        block = torch.arange(64.0).reshape(8, 8)
        padded = EX.shard_halo_pad(block, 2, mesh)
        idx = np.arange(-2, 10) % 8
        np.testing.assert_array_equal(
            padded.numpy(), block.numpy()[idx[:, None], idx[None, :]])
    finally:
        dist.destroy_process_group()
