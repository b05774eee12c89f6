#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — builds ``src/repro_torch/csrc/tap_window.cu`` (the window
             kernel K1) and ``pyramid_window.cu`` (the fused-pyramid
             kernels K2/K3) with nvcc for sm_90a, both at once, and prints
             the build times and the ``-Xptxas -v`` registers and spills;
2. kernel  — each kernel against its plain version on the same CUDA
             tensors: K1 (``tap_window_ref``) for every wavelet x scheme x
             optimize x fuse x direction x tap_opt on batched non-smooth
             planes (37x53, 24x509) and on the main path's plane shapes;
             K2/K3 (``pyramid_forward_ref`` / ``pyramid_inverse_ref``) for
             every wavelet x scheme x tap_opt x direction at 1-3 levels on
             batched non-smooth images (3x296x424, 2x256x4072) and for
             every scheme at 7 levels (2x256x384), at the tiles the
             plan's guard picks.  float32 must agree bit for bit
             (max |diff| = 0), float16/bfloat16 I/O and bfloat16 compute
             within the bounds below (the largest |diff| is printed);
3. main    — ``repro_torch.dwt2`` / ``idwt2`` at B=8, 2048x2048, float32,
             3 levels, cdf97 on backend "cuda": ns-polyconv at fuse
             "none", "scheme", "levels" and "pyramid", sep-lifting at
             "none".  Each
             path runs with every launch counter at 0 and must launch
             exactly ``plan.launches`` kernels per transform (for
             "pyramid": one K2 and one K3, ``plan.pyramid`` set); the
             round trip must hold to ROUNDTRIP_TOL and the coefficients
             must agree with backend "torch" to CROSS_TOL; "pyramid" must
             equal "levels" bit for bit; a small input must agree with
             the filter-bank oracle; 7 levels of sep-lifting must run as
             one K2 and one K3 launch and equal "levels" bit for bit;
             a budget below one level's window
             ($REPRO_TORCH_PYRAMID_SMEM_LIMIT) must fall back to
             "levels", counted, and compute what "levels" computes;
3c. workloads — packets, 3-D and the conv backend, each path with every
             counter at 0, cdf97, float32: ``wpt2``/``iwpt2`` of
             "full:2" at B=8, 2048x2048 (ns-polyconv, backend "cuda",
             fuse "none" and "levels": 10 and 5 K1 launches per
             transform); ``dwt3``/``idwt3`` of a 1x64x1024x1024 volume at
             3 levels (12 and 6; ``plan.fallback`` names the unfused
             temporal pass); ``dwt2``/``idwt2`` of the main path on
             backend "conv" (ns-polyconv "none" and "levels",
             sep-lifting "none": 6, 3 and 24 ``F.conv2d`` calls), run
             before phase 4 turns TF32 off and checked to leave cuDNN's
             TF32 setting as it found it.  Results within CROSS_TOL of
             backend "torch", round trips within ROUNDTRIP_TOL;
             ``wpt2(packet="dwt:3")`` equal to ``dwt2(levels=3)`` bit for
             bit; ``best_basis`` (depth 2, shannon) the same tree on
             "cuda" and "torch", and that tree round-trips.  Times
             (median of 5) beside backend "torch" (and, for the conv
             path, "cuda"), ``temporal_forward`` alone at level 0, and
             K1's launches per path;
4. times   — CUDA events after warm-up, median of 7 runs: per launch and
             per transform, kernel vs plain version vs torch backend,
             bytes, GB/s and the bound (bytes / 3.35 TB/s against
             operations / 67 TFLOP/s); per K1 launch the barriers per
             tile, the shared reads per position (one per term), the
             grid and the resident blocks per SM; for K2 and K3 their
             per-level tiles, grid, resident blocks per SM and LL
             scratch bytes; K1's library yardstick is one
             F.conv2d of the composed filter bank of the fused level
             (cuDNN with TF32 off); K2/K3 have none (no one PyTorch call
             computes a multi-level pyramid), and are printed beside the
             port's own fuse="levels" transform;
5. result  — the card's name and power limit, one JSON line listing every
             kernel, and the last line
             {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# tolerance contract of the reference (tests/test_differential.py:48/:54)
ROUNDTRIP_TOL = {"float32": dict(rtol=1e-3, atol=1e-4)}
CROSS_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "float16": dict(rtol=2e-2, atol=2e-3)}
# kernel vs plain version: float32 compute with float32 I/O must be
# exact; half-precision I/O and bfloat16 compute are held to the
# reference's float16 cross-backend bound (same algebra, the only slack
# being the rounding of the narrow type)
KERNEL_TOL = {"float32": dict(rtol=0.0, atol=0.0),
              "narrow": CROSS_TOL["float16"]}

WAVELETS = ("cdf53", "cdf97", "dd137")
SCHEMES = ("sep-conv", "sep-lifting", "sep-polyconv", "ns-conv",
           "ns-polyconv", "ns-lifting")
MAIN = dict(batch=8, size=2048, levels=3, wavelet="cdf97")
MAIN_CONFIGS = (("ns-polyconv", "none"), ("ns-polyconv", "scheme"),
                ("sep-lifting", "none"), ("ns-polyconv", "levels"),
                ("ns-polyconv", "pyramid"))
EXPECTED_LAUNCHES = {("ns-polyconv", "none"): 6,
                     ("ns-polyconv", "scheme"): 3,
                     ("sep-lifting", "none"): 24,
                     ("ns-polyconv", "levels"): 3,
                     ("ns-polyconv", "pyramid"): 1}
# phase 3c: packets on the main path's images, a 64-frame 1024^2 volume
PACKET_LAUNCHES = {"none": 10, "levels": 5}      # full:2, 5 nodes
VOLUME = dict(shape=(1, 64, 1024, 1024), levels=3)
DWT3_LAUNCHES = {"none": 12, "levels": 6}        # 2 half-bands per level
CONV_LAUNCHES = {("ns-polyconv", "none"): 6, ("ns-polyconv", "levels"): 3,
                 ("sep-lifting", "none"): 24}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
REPS = 7
TPU_KERNELS = {"tap_window": "src/repro/kernels/polyphase.py:203",
               "pyramid_forward": "src/repro/kernels/polyphase.py:385",
               "pyramid_inverse": "src/repro/kernels/polyphase.py:493"}
SOURCES = {"tap_window": "src/repro_torch/csrc/tap_window.cu",
           "pyramid_forward": "src/repro_torch/csrc/pyramid_window.cu",
           "pyramid_inverse": "src/repro_torch/csrc/pyramid_window.cu"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_violation(a, b, rtol, atol):
    """Largest |a-b| - (atol + rtol*|b|), in float64 (<= 0 passes)."""
    a = a.double()
    b = b.double()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


class Timer:
    """Median of REPS runs: CUDA events on the card, perf_counter on CPU."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def ms(self, fn, reps=REPS, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def kernels(TW, PW):
    """Every kernel of the main path: name -> its launch counter."""
    return {"tap_window": TW.KERNEL, "pyramid_forward": PW.FORWARD,
            "pyramid_inverse": PW.INVERSE}


def phase_build(TW, PW, cpu):
    print("== phase 1: build", flush=True)
    if cpu:
        print("cpu rehearsal: kernels not built (no nvcc on this machine)")
        return
    libs = (TW.LIBRARY, PW.LIBRARY)
    errors = []

    def build(lib):
        try:
            lib.library()
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"built in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"  {lib.path} (nvcc {lib.build_seconds} s)")
        for line in lib.ptxas_log.splitlines():
            if any(k in line for k in ("Compiling", "registers", "spill",
                                       "smem")):
                print("    ptxas:", line.strip())


def _planes(torch, gen, shape, dtype, device):
    return [torch.randn(shape, generator=gen, dtype=torch.float32)
            .to(device=device, dtype=dtype) for _ in range(4)]


def phase_kernel(torch, C, TW, device, cpu, gen):
    """Kernel vs plain version; returns the largest fp32 |diff|."""
    print("== phase 2: kernel vs plain version", flush=True)
    shapes = [(2, 9, 13)] if cpu else [(3, 37, 53), (2, 24, 509)]
    worst = {"float32": 0.0, "narrow": 0.0}
    n_cases = 0

    def compare(prog, shape, io_dtype, cdt):
        nonlocal n_cases
        block = TW.fit_block((prog,), shape[1], shape[2])
        win = TW.encode(prog, block, cdt)
        planes = _planes(torch, gen, shape, io_dtype, device)
        got = TW.tap_window(win, planes)
        want = TW.tap_window_ref(win, planes)
        exact = io_dtype == torch.float32 and cdt == "float32"
        tol = KERNEL_TOL["float32" if exact else "narrow"]
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"kernel output {g.dtype} {tuple(g.shape)} vs plain "
                  f"{w.dtype} {tuple(w.shape)}")
            d = max_abs(g, w)
            worst["float32" if exact else "narrow"] = max(
                worst["float32" if exact else "narrow"], d)
            check(rel_violation(g, w, **tol) <= 0,
                  f"kernel disagrees with plain version: max |diff| {d} "
                  f"(shape {shape}, io {io_dtype}, compute {cdt}, "
                  f"block {block}, halo {win.halo})")
        n_cases += 1

    t0 = time.perf_counter()
    for w, s, opt, inv, fuse, tap_opt in itertools.product(
            WAVELETS, SCHEMES, (False, True), (False, True),
            ("none", "scheme"), ("off", "exact", "full")):
        if inv and opt:
            continue          # the inverse ignores optimize
        for prog in C.compile_scheme_programs(w, s, opt, inv, tap_opt,
                                              fuse):
            for shape in shapes:
                compare(prog, shape, torch.float32, "float32")
    # half-precision I/O and bf16 compute on the main-path programs
    for (s, fuse), inv, (io, cdt) in itertools.product(
            MAIN_CONFIGS, (False, True),
            ((torch.float16, "float32"), (torch.bfloat16, "float32"),
             (torch.float32, "bfloat16"), (torch.bfloat16, "bfloat16"))):
        for prog in C.compile_scheme_programs(MAIN["wavelet"], s, False,
                                              inv, "full", fuse):
            compare(prog, shapes[0], io, cdt)
    # the main path's own plane shapes
    b = 2 if cpu else MAIN["batch"]
    hp = 8 if cpu else MAIN["size"] // 2
    for (s, fuse), inv in itertools.product(MAIN_CONFIGS, (False, True)):
        for lvl in range(MAIN["levels"]):
            for prog in C.compile_scheme_programs(MAIN["wavelet"], s, False,
                                                  inv, "full", fuse):
                compare(prog, (b, hp >> lvl, hp >> lvl), torch.float32,
                        "float32")
    print(f"{n_cases} kernel/plain comparisons in "
          f"{time.perf_counter() - t0:.1f} s: max |diff| float32 "
          f"{worst['float32']!r}, half-precision {worst['narrow']!r}")
    return worst["float32"]


def phase_pyramid_kernel(torch, R, PW, device, cpu, gen):
    """K2/K3 vs their plain versions; returns the largest fp32 |diff| of
    each."""
    print("== phase 2b: fused-pyramid kernels vs plain versions", flush=True)
    shapes = [(2, 40, 56)] if cpu else [(3, 296, 424), (2, 256, 4072)]
    worst = {"pyramid_forward": 0.0, "pyramid_inverse": 0.0, "narrow": 0.0}
    n_cases = 0

    def compare(name, got, want, exact, what):
        nonlocal n_cases
        tol = KERNEL_TOL["float32" if exact else "narrow"]
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{name} output {g.dtype} {tuple(g.shape)} vs plain "
                  f"{w.dtype} {tuple(w.shape)} ({what})")
            d = max_abs(g, w)
            key = name if exact else "narrow"
            worst[key] = max(worst[key], d)
            check(rel_violation(g, w, **tol) <= 0,
                  f"{name} disagrees with its plain version: max |diff| "
                  f"{d} ({what})")
        n_cases += 1

    def run(wavelet, scheme, levels, tap_opt, shape, io, cdt):
        spec = R.get_plan(
            wavelet=wavelet, scheme=scheme, levels=levels, shape=shape,
            dtype=str(io).replace("torch.", ""), backend="cuda",
            fuse="pyramid", compute_dtype=cdt, tap_opt=tap_opt,
            device=device, cache=R.PlanCache()).pyramid
        if spec is None:
            return False
        what = (f"{wavelet} {scheme} L={levels} tap_opt={tap_opt} shape "
                f"{shape} io {io} compute {cdt} block {spec.block}")
        exact = io == torch.float32 and cdt == "float32"
        x = torch.randn(shape, generator=gen).to(device=device, dtype=io)
        ll, det = PW.pyramid_forward(spec.fwd_kernel, x)
        rll, rdet = PW.pyramid_forward_ref(spec.fwd_kernel, x)
        compare("pyramid_forward", [ll] + [d for t in det for d in t],
                [rll] + [d for t in rdet for d in t], exact, what)
        rec = PW.pyramid_inverse(spec.inv_kernel, ll, det)
        compare("pyramid_inverse", [rec],
                [PW.pyramid_inverse_ref(spec.inv_kernel, ll, det)], exact,
                what)
        return True

    t0 = time.perf_counter()
    skipped = []
    for w, sch, levels, tap_opt, shape in itertools.product(
            WAVELETS, SCHEMES, (1, 2, 3), ("off", "exact", "full"),
            shapes):
        if not run(w, sch, levels, tap_opt, shape, torch.float32,
                   "float32"):
            skipped.append((w, sch, levels, tap_opt, shape))
    # seven levels: the coarsest planes (2x3) are far smaller than a tile
    for sch in SCHEMES:
        check(run(MAIN["wavelet"], sch, 7, "full", (2, 256, 384),
                  torch.float32, "float32"), f"{sch} falls back at 7 levels")
    for sch, (io, cdt) in itertools.product(
            ("ns-polyconv", "sep-lifting"),
            ((torch.float16, "float32"), (torch.bfloat16, "float32"),
             (torch.float32, "bfloat16"), (torch.bfloat16, "bfloat16"))):
        check(run(MAIN["wavelet"], sch, MAIN["levels"], "full", shapes[-1],
                  io, cdt), f"{sch} falls back at {shapes[-1]}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"{n_cases} fused-pyramid kernel/plain comparisons in "
          f"{time.perf_counter() - t0:.1f} s: max |diff| float32 "
          f"forward {worst['pyramid_forward']!r}, inverse "
          f"{worst['pyramid_inverse']!r}, half-precision/bf16 "
          f"{worst['narrow']!r}; {len(skipped)} configurations fell back "
          f"to fuse='levels' (no kernel to compare): {skipped}")
    return worst


def phase_main(torch, R, TW, PW, device, cpu, gen):
    """The port's main path, each configuration with every launch counter
    at 0; returns (launches per kernel, plans, x)."""
    print("== phase 3: main path", flush=True)
    from repro_torch.kernels.ref import dwt2_ref
    b, n = (2, 64) if cpu else (MAIN["batch"], MAIN["size"])
    L, wav = MAIN["levels"], MAIN["wavelet"]
    x = torch.randn((b, n, n), generator=gen).to(device)
    common = dict(wavelet=wav, levels=L, device=device)
    # small input against the independent filter-bank oracle
    small = torch.randn((2, 64, 96), generator=gen).to(device)
    got = R.dwt2(small, wavelet=wav, backend="cuda", device=device)
    want = dwt2_ref(small, wav)
    for g, w in zip([got.ll, *got.details[0]], want):
        check(rel_violation(g, w, **CROSS_TOL["float32"]) <= 0,
              f"dwt2 disagrees with the filter-bank oracle: "
              f"{max_abs(g, w)}")
    counters = kernels(TW, PW)
    plans = {}
    launched = {name: 0 for name in counters}
    for scheme, fuse in MAIN_CONFIGS:
        plan = R.get_plan(shape=tuple(x.shape), scheme=scheme, fuse=fuse,
                          backend="cuda", **common)
        plans[(scheme, fuse)] = plan
        check(plan.launches == EXPECTED_LAUNCHES[(scheme, fuse)],
              f"{scheme}/{fuse}: plan.launches {plan.launches}")
        if fuse == "pyramid":
            check(plan.pyramid is not None,
                  f"{scheme}/pyramid fell back: {plan.fallback}")
        # the path itself, every counter at 0 just before it
        for k in counters.values():
            k.launches = 0
        pyr = R.dwt2(x, scheme=scheme, fuse=fuse, backend="cuda", **common)
        fwd = {name: k.launches for name, k in counters.items()}
        rec = R.idwt2(pyr, scheme=scheme, fuse=fuse, backend="cuda",
                      device=device, wavelet=wav)
        if device.type == "cuda":
            torch.cuda.synchronize()
        both = {name: k.launches for name, k in counters.items()}
        for name in launched:
            launched[name] += both[name]
        n_fwd, n_all = sum(fwd.values()), sum(both.values())
        if device.type == "cuda":
            check(n_fwd == plan.launches and n_all == 2 * plan.launches,
                  f"{scheme}/{fuse}: counted {n_fwd} forward / "
                  f"{n_all - n_fwd} inverse launches, plan says "
                  f"{plan.launches}")
            if fuse == "pyramid":
                check(fwd == {"tap_window": 0, "pyramid_forward": 1,
                              "pyramid_inverse": 0}
                      and both["pyramid_inverse"] == 1,
                      f"pyramid launches {fwd} then {both}")
        shapes = [tuple(pyr.ll.shape)] + [tuple(d.shape) for det in
                                          pyr.details for d in det]
        want = [(b, n >> L, n >> L)] + [(b, n >> l, n >> l) for l in
                                        range(L, 0, -1) for _ in range(3)]
        check(shapes == want, f"pyramid shapes {shapes} != {want}")
        planes = [pyr.ll] + [d for det in pyr.details for d in det]
        check(all(bool(torch.isfinite(p).all()) for p in planes),
              "non-finite coefficients")
        rt = rel_violation(rec, x, **ROUNDTRIP_TOL["float32"])
        check(rt <= 0, f"{scheme}/{fuse}: round trip off by {max_abs(rec, x)}")
        ref = R.dwt2(x, scheme=scheme, fuse=fuse, backend="torch", **common)
        ref_planes = [ref.ll] + [d for det in ref.details for d in det]
        cross = max(max_abs(p, q) for p, q in zip(planes, ref_planes))
        check(all(rel_violation(p, q, **CROSS_TOL["float32"]) <= 0
                  for p, q in zip(planes, ref_planes)),
              f"{scheme}/{fuse}: cuda vs torch backend off by {cross}")
        extra = ""
        if fuse == "pyramid":
            lvl = R.dwt2(x, scheme=scheme, fuse="levels", backend="cuda",
                         **common)
            lvl_planes = [lvl.ll] + [d for det in lvl.details for d in det]
            d_fwd = max(max_abs(p, q) for p, q in zip(planes, lvl_planes))
            d_inv = max_abs(rec, R.idwt2(pyr, scheme=scheme, fuse="levels",
                                         backend="cuda", device=device,
                                         wavelet=wav))
            check(d_fwd == 0 and d_inv == 0,
                  f"pyramid vs levels on cuda: forward {d_fwd}, inverse "
                  f"{d_inv}")
            extra = (f"; vs fuse=levels max |diff| forward {d_fwd!r} "
                     f"inverse {d_inv!r}; block {plan.pyramid.block}, smem "
                     f"{plan.pyramid.smem_bytes} B")
            del lvl, lvl_planes
        print(f"{scheme:12s} fuse={fuse:7s} launches fwd {n_fwd} inv "
              f"{n_all - n_fwd} (plan {plan.launches}); round trip max "
              f"|diff| {max_abs(rec, x)!r}; vs torch backend max |diff| "
              f"{cross!r}{extra}")
        del pyr, rec, ref, planes, ref_planes
    print(f"main path launches: {launched}")
    phase_deep(torch, R, PW, device, gen)
    return launched, plans, x


def phase_deep(torch, R, PW, device, gen):
    """Seven levels of sep-lifting as one K2 and one K3 launch, equal to
    fuse="levels"; then the shared-memory guard's fallback, forced by a
    budget below one level's window."""
    import os
    from repro_torch.engine import PYRAMID_COUNTERS
    from repro_torch.engine.plan import PYRAMID_SMEM_LIMIT_ENV
    wav = MAIN["wavelet"]
    kw = dict(wavelet=wav, scheme="sep-lifting", device=device)
    deep = torch.randn((1, 256, 256), generator=gen).to(device)
    before = PYRAMID_COUNTERS["smem_fallbacks"]
    plan = R.get_plan(shape=tuple(deep.shape), levels=7, fuse="pyramid",
                      backend="cuda", cache=R.PlanCache(), **kw)
    check(plan.pyramid is not None and plan.launches == 1
          and PYRAMID_COUNTERS["smem_fallbacks"] == before,
          f"7-level sep-lifting fell back: {plan.fallback}")
    n0 = (PW.FORWARD.launches, PW.INVERSE.launches)
    a = plan.execute(deep)
    rec = plan.execute_inverse(a)
    if device.type == "cuda":
        torch.cuda.synchronize()
        check((PW.FORWARD.launches, PW.INVERSE.launches)
              == (n0[0] + 1, n0[1] + 1),
              "7-level pyramid did not run as one K2 and one K3 launch")
    b = R.dwt2(deep, levels=7, fuse="levels", **kw)
    planes = [a.ll] + [d for det in a.details for d in det]
    check(all(torch.equal(p, q) for p, q in
              zip(planes, [b.ll] + [d for det in b.details for d in det])),
          "7-level pyramid dwt2 differs from fuse='levels'")
    lvl_rec = R.idwt2(a, fuse="levels", **kw)
    check(torch.equal(rec, lvl_rec),
          f"7-level pyramid idwt2 differs from fuse='levels': "
          f"{max_abs(rec, lvl_rec)}")
    print(f"7-level sep-lifting: one K2 + one K3 launch, equal to "
          f"fuse='levels'; tiles {plan.pyramid.inv_kernel.level_blocks}, "
          f"smem {plan.pyramid.smem_bytes} B")
    old = os.environ.get(PYRAMID_SMEM_LIMIT_ENV)
    os.environ[PYRAMID_SMEM_LIMIT_ENV] = "4096"
    try:
        plan = R.get_plan(shape=tuple(deep.shape), levels=7, fuse="pyramid",
                          backend="cuda", cache=R.PlanCache(), **kw)
    finally:
        if old is None:
            del os.environ[PYRAMID_SMEM_LIMIT_ENV]
        else:
            os.environ[PYRAMID_SMEM_LIMIT_ENV] = old
    check(plan.pyramid is None and plan.launches == 7
          and PYRAMID_COUNTERS["smem_fallbacks"] == before + 1,
          f"a 4096 B budget did not fall back: {plan.fallback}")
    a = plan.execute(deep)
    check(all(torch.equal(p, q) for p, q in
              zip([a.ll] + [d for det in a.details for d in det],
                  [b.ll] + [d for det in b.details for d in det]))
          and torch.equal(plan.execute_inverse(a), lvl_rec),
          "fallback plan differs from fuse='levels'")
    print(f"fallback: {plan.fallback}")


def _flat(out):
    """Every tensor of a Pyramid / Pyramid3 / WaveletPacket2D, in order."""
    if hasattr(out, "leaves"):
        return list(out.leaves)
    return [out.ll] + [d for det in out.details for d in det]


def _cudnn_tf32(torch):
    """cuDNN's TF32 settings, both APIs where this PyTorch has both."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    return (torch.backends.cudnn.allow_tf32,
            getattr(conv, "fp32_precision", None))


def phase_workloads(torch, R, TW, PW, CV, device, cpu, gen, x, timer):
    """Packets, 3-D and the conv backend (phase 3c); returns K1's
    launches summed over the packet and 3-D paths."""
    print("== phase 3c: packets, 3-D and the conv backend", flush=True)
    from repro_torch.compiler import temporal as TP
    wav = MAIN["wavelet"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    counters = kernels(TW, PW)
    per_path = {}

    def counted(name, run_fwd, run_inv, plan):
        """Run one path forward then inverse with every counter at 0;
        check K1's launches against ``plan.launches``."""
        for k in counters.values():
            k.launches = 0
        out = run_fwd()
        n_fwd = TW.KERNEL.launches
        rec = run_inv(out)
        sync()
        n_all = TW.KERNEL.launches
        if device.type == "cuda":
            others = {n: k.launches for n, k in counters.items()
                      if n != "tap_window"}
            check(n_fwd == plan.launches and n_all == 2 * plan.launches
                  and not any(others.values()),
                  f"{name}: counted {n_fwd} forward / {n_all - n_fwd} "
                  f"inverse K1 launches (others {others}), plan says "
                  f"{plan.launches}")
        per_path[name] = n_all
        return out, rec

    def held(name, out, ref, rec, orig):
        got, want = _flat(out), _flat(ref)
        check([tuple(a.shape) for a in got] == [tuple(b.shape) for b in want]
              and all(bool(torch.isfinite(a).all()) for a in got),
              f"{name}: shapes or finiteness")
        cross = max(max_abs(a, b) for a, b in zip(got, want))
        check(all(rel_violation(a, b, **CROSS_TOL["float32"]) <= 0
                  for a, b in zip(got, want)),
              f"{name}: vs torch backend off by {cross}")
        rt = max_abs(rec, orig)
        check(rel_violation(rec, orig, **ROUNDTRIP_TOL["float32"]) <= 0,
              f"{name}: round trip off by {rt}")
        print(f"{name}: vs torch backend max |diff| {cross!r}; round trip "
              f"max |diff| {rt!r}")

    # -- wavelet packets on the main path's images ----------------------
    b, n = (2, 64) if cpu else (MAIN["batch"], MAIN["size"])
    xp = torch.randn((b, n, n), generator=gen).to(device)
    kw = dict(wavelet=wav, scheme="ns-polyconv", device=device)
    for fuse in ("none", "levels"):
        plan = R.get_plan(shape=tuple(xp.shape), packet="full:2", fuse=fuse,
                          backend="cuda", **kw)
        check(plan.launches == PACKET_LAUNCHES[fuse],
              f"packets/{fuse}: plan.launches {plan.launches}")
        pk, rec = counted(
            f"wpt2/iwpt2 full:2 {fuse}",
            lambda: R.wpt2(xp, packet="full:2", fuse=fuse, backend="cuda",
                           **kw),
            lambda out: R.iwpt2(out, fuse=fuse, backend="cuda", **kw), plan)
        held(f"wpt2 full:2 {fuse}", pk,
             R.wpt2(xp, packet="full:2", fuse=fuse, backend="torch", **kw),
             rec, xp)
        del pk, rec
    pk = R.wpt2(xp, packet="dwt:3", fuse="levels", backend="cuda", **kw)
    pyr = R.dwt2(xp, levels=3, fuse="levels", backend="cuda", **kw)
    want = [pyr.ll] + [d for det in pyr.details for d in det]  # coarsest first
    got = [pk[p] for p in ("aaa", "aah", "aav", "aad", "ah", "av", "ad",
                           "h", "v", "d")]
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "wpt2(packet='dwt:3') differs from dwt2(levels=3)")
    print("wpt2(packet='dwt:3') equals dwt2(levels=3) bit for bit")
    del pk, pyr, want, got
    trees = {be: R.best_basis(xp, depth=2, cost="shannon", backend=be,
                              **kw) for be in ("cuda", "torch")}
    check(trees["cuda"] == trees["torch"],
          f"best_basis differs: cuda {trees['cuda'].leaves}, torch "
          f"{trees['torch'].leaves}")
    pk = R.wpt2(xp, packet=trees["cuda"], backend="cuda", **kw)
    rec = R.iwpt2(pk, backend="cuda", **kw)
    check(rel_violation(rec, xp, **ROUNDTRIP_TOL["float32"]) <= 0,
          f"best-basis round trip off by {max_abs(rec, xp)}")
    print(f"best_basis (depth 2, shannon): the same {len(trees['cuda'])} "
          f"leaves on cuda and torch {trees['cuda'].leaves}; round trip "
          f"max |diff| {max_abs(rec, xp)!r}")
    del pk, rec

    # -- the t+2D volume ------------------------------------------------
    shape3 = (1, 16, 32, 32) if cpu else VOLUME["shape"]
    L3 = VOLUME["levels"]
    vol = torch.randn(shape3, generator=gen).to(device)
    kw3 = dict(wavelet=wav, scheme="ns-polyconv", levels=L3, device=device)
    for fuse in ("none", "levels"):
        plan = R.get_plan(shape=shape3, ndim=3, fuse=fuse, backend="cuda",
                          **kw3)
        check(plan.launches == DWT3_LAUNCHES[fuse],
              f"dwt3/{fuse}: plan.launches {plan.launches}")
        if fuse == "levels":
            check("temporal pass runs unfused" in (plan.fallback or ""),
                  f"dwt3/levels fallback: {plan.fallback}")
            print(f"dwt3/levels fallback: {plan.fallback}")
        p3, rec = counted(
            f"dwt3/idwt3 {fuse}",
            lambda: R.dwt3(vol, fuse=fuse, backend="cuda", **kw3),
            lambda out: R.idwt3(out, fuse=fuse, backend="cuda",
                                wavelet=wav, device=device), plan)
        check(len(p3.details) == L3 and all(len(d) == 7 for d in p3.details),
              "dwt3: 7 subbands per level")
        held(f"dwt3 {fuse}", p3, R.dwt3(vol, fuse=fuse, backend="torch",
                                        **kw3), rec, vol)
        del p3, rec

    # -- the conv backend on the main path, TF32 left as found ----------
    tf32 = _cudnn_tf32(torch)
    print(f"cuDNN TF32 as found: allow_tf32={tf32[0]}, "
          f"conv.fp32_precision={tf32[1]!r}; the conv backend pins full "
          f"fp32 around its calls")
    conv_calls = {}
    kwc = dict(wavelet=wav, levels=MAIN["levels"], device=device)
    for (scheme, fuse), want_n in CONV_LAUNCHES.items():
        plan = R.get_plan(shape=tuple(x.shape), scheme=scheme, fuse=fuse,
                          backend="conv", **kwc)
        check(plan.launches == want_n,
              f"conv {scheme}/{fuse}: plan.launches {plan.launches}")
        CV.CONV2D.launches = 0
        pyr = R.dwt2(x, scheme=scheme, fuse=fuse, backend="conv", **kwc)
        n_fwd = CV.CONV2D.launches
        rec = R.idwt2(pyr, scheme=scheme, fuse=fuse, backend="conv",
                      wavelet=wav, device=device)
        sync()
        n_all = CV.CONV2D.launches
        check(n_fwd == want_n and n_all == 2 * want_n,
              f"conv {scheme}/{fuse}: counted {n_fwd} forward / "
              f"{n_all - n_fwd} inverse F.conv2d calls, plan says {want_n}")
        conv_calls[f"{scheme}/{fuse}"] = n_all
        held(f"conv {scheme}/{fuse}", pyr,
             R.dwt2(x, scheme=scheme, fuse=fuse, backend="torch", **kwc),
             rec, x)
        del pyr, rec
    check(_cudnn_tf32(torch) == tf32,
          f"the conv backend changed cuDNN's TF32 setting: {tf32} -> "
          f"{_cudnn_tf32(torch)}")
    # what the pin guards against: the fused level-0 conv as cuDNN runs
    # it under the setting as found, beside the same conv at full fp32
    import torch.nn.functional as F
    from repro_torch.core.schemes import to_planes
    prog = R.get_plan(shape=tuple(x.shape), scheme="ns-polyconv",
                      fuse="levels", backend="conv",
                      **kwc).level_specs[0].fwd_programs[0]
    rn, rm = CV.lower_program_to_conv(prog).pad
    xs = CV._wrap_pad(torch.stack(to_planes(x), dim=-3), rn, rm).contiguous()
    w = CV._weights(prog, torch.float32, x.device)
    as_found = F.conv2d(xs, w)
    with CV.full_fp32():
        pinned = F.conv2d(xs, w)
    print(f"fused level-0 conv under the TF32 setting as found vs full "
          f"fp32: max |diff| {max_abs(as_found, pinned)!r}")
    del xs, as_found, pinned
    print(f"conv path F.conv2d calls (forward + inverse): {conv_calls}")
    print(f"K1 launches per path (forward + inverse): {per_path}")

    # -- times (median of 5) --------------------------------------------
    print("path,backend,fuse,forward_ms,inverse_ms")

    def pair(name, backend, fuse, fwd, inv):
        out = fwd()
        f_ms = timer.ms(fwd, reps=5, warmup=1)
        i_ms = timer.ms(lambda: inv(out), reps=5, warmup=1)
        print(f"{name},{backend},{fuse},{f_ms:.4f},{i_ms:.4f}")
        return f_ms, i_ms

    for be, fuse in (("cuda", "none"), ("cuda", "levels"),
                     ("torch", "levels")):
        pair("wpt2/iwpt2 full:2", be, fuse,
             lambda: R.wpt2(xp, packet="full:2", fuse=fuse, backend=be,
                            **kw),
             lambda o: R.iwpt2(o, fuse=fuse, backend=be, **kw))
    d3 = {}
    for be, fuse in (("cuda", "none"), ("cuda", "levels"),
                     ("torch", "levels")):
        d3[(be, fuse)] = pair(
            "dwt3/idwt3", be, fuse,
            lambda: R.dwt3(vol, fuse=fuse, backend=be, **kw3),
            lambda o: R.idwt3(o, fuse=fuse, backend=be, wavelet=wav,
                              device=device))
    for (scheme, fuse) in CONV_LAUNCHES:
        for be in ("conv", "cuda", "torch"):
            pair(f"dwt2/idwt2 {scheme}", be, fuse,
                 lambda: R.dwt2(x, scheme=scheme, fuse=fuse, backend=be,
                                **kwc),
                 lambda o: R.idwt2(o, scheme=scheme, fuse=fuse, backend=be,
                                   wavelet=wav, device=device))
    fprog = TP.compile_temporal(wav)
    iprog = TP.compile_temporal(wav, inverse=True)
    lo, hi = TP.temporal_forward(vol, fprog)
    t_fwd = timer.ms(lambda: TP.temporal_forward(vol, fprog), reps=5,
                     warmup=1)
    t_inv = timer.ms(lambda: TP.temporal_inverse(lo, hi, iprog), reps=5,
                     warmup=1)
    f3, i3 = d3[("cuda", "levels")]
    print(f"temporal pass at level 0 of {shape3}: forward {t_fwd:.4f} ms "
          f"({t_fwd / f3:.4f} of dwt3 cuda/levels {f3:.4f} ms), inverse "
          f"{t_inv:.4f} ms ({t_inv / i3:.4f} of idwt3 {i3:.4f} ms)")
    del xp, vol, lo, hi
    return sum(per_path.values())


def _pyramid_bytes(PP, pw, h, w):
    """Modelled and unique bytes of one fused-pyramid launch per image."""
    return PP.pyramid_hbm_bytes((h, w), 4, pw.level_blocks,
                                [p.halo for p in pw.programs])


def _time_transforms(torch, R, PP, device, plans, x, timer):
    print("config,transform,backend,launches,ms,image_GB/s,model_bytes,"
          "model_bound_ms")
    b = x.shape[0]
    times = {}
    for (scheme, fuse), plan in plans.items():
        common = dict(wavelet=MAIN["wavelet"], scheme=scheme, fuse=fuse,
                      device=device)
        if plan.pyramid is not None:
            spec = plan.pyramid
            model = {op: _pyramid_bytes(PP, pw, *x.shape[-2:]).modelled * b
                     for op, pw in (("fwd", spec.fwd_kernel),
                                    ("inv", spec.inv_kernel))}
        else:
            # modelled bytes of the kernel path: every launch's windows
            # and outputs plus the split/merge copy, summed over the levels
            model = {op: sum(PP.scheme_hbm_bytes(
                getattr(spec, f"{op}_programs"), spec.image_shape, 4,
                spec.block) for spec in plan.level_specs) * b
                for op in ("fwd", "inv")}
        for backend in ("cuda", "torch"):
            pyr = R.dwt2(x, backend=backend, levels=MAIN["levels"], **common)
            f_ms = timer.ms(lambda: R.dwt2(x, backend=backend,
                                           levels=MAIN["levels"], **common),
                            reps=5, warmup=1)
            i_ms = timer.ms(lambda: R.idwt2(pyr, backend=backend, **common),
                            reps=5, warmup=1)
            times[(scheme, fuse, backend)] = (f_ms, i_ms)
            n = plan.launches if backend == "cuda" else 0
            gb = x.numel() * 4 / 1e6
            for op, t_ms, key in (("dwt2", f_ms, "fwd"),
                                  ("idwt2", i_ms, "inv")):
                print(f"{scheme}/{fuse},{op},{backend},{n},{t_ms:.4f},"
                      f"{gb / t_ms:.1f},{model[key]},"
                      f"{model[key] / HBM_BYTES_PER_S * 1e3:.4f}")
            del pyr
    return times


def phase_times(torch, R, PP, TW, PW, CV, device, plans, x, timer):
    """Per-launch and per-transform times; returns the kernels-line
    entries: K1 measured on the fused level (ns-polyconv, fuse=scheme,
    level 0), K2/K3 on the main path's pyramid."""
    print("== phase 4: times (median of %d, CUDA events)" % REPS, flush=True)
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = False")
    print("config,level,launch,planes,halo,block,smem,kernel_ms,plain_ms,"
          "bytes,GB/s,bound_ms,bound_by,ops,term_evals,barriers,"
          "reads_per_position,grid,blocks_per_sm")
    b = x.shape[0]
    entries = {}
    for (scheme, fuse), plan in plans.items():
        if plan.pyramid is not None:
            continue
        for spec in plan.level_specs:
            hp, wp = spec.plane_shape
            planes = _planes(torch, torch.Generator().manual_seed(7),
                             (b, hp, wp), torch.float32, device)
            for i, win in enumerate(spec.fwd_windows):
                k_ms = timer.ms(lambda: TW.tap_window(win, planes))
                grid, per_sm = TW.KERNEL.last_grid
                p_ms = timer.ms(lambda: TW.tap_window_ref(win, planes),
                                reps=5, warmup=1)
                nbytes = 8 * b * hp * wp * 4
                st = win.program.stats()
                ops = (st["muls"] + st["adds"]) * b * hp * wp
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / FP32_FLOPS * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                print(f"{scheme}/{fuse},{spec.index},{i},{b}x{hp}x{wp},"
                      f"{win.halo},{win.block[0]}x{win.block[1]},"
                      f"{win.smem_bytes},{k_ms:.4f},{p_ms:.4f},{nbytes},"
                      f"{nbytes / k_ms / 1e6:.1f},{bound:.4f},{by},{ops},"
                      f"{win.term_evaluations((b, hp, wp))},{win.barriers},"
                      f"{win.terms},{grid},{per_sm}")
                if (scheme, fuse) == ("ns-polyconv", "scheme") \
                        and spec.index == 0:
                    conv = CV.lower_program_to_conv(win.program)
                    rn, rm = conv.pad
                    ri = torch.arange(-rn, hp + rn, device=device) % hp
                    ci = torch.arange(-rm, wp + rm, device=device) % wp
                    xp = torch.stack(planes, 1).index_select(2, ri) \
                        .index_select(3, ci).contiguous()
                    wt = torch.tensor(conv.weights, dtype=torch.float32,
                                      device=device)
                    got = F.conv2d(xp, wt)
                    ours = TW.tap_window(win, planes)
                    d = max(max_abs(got[:, k], ours[k]) for k in range(4))
                    check(all(rel_violation(got[:, k], ours[k],
                                            **CROSS_TOL["float32"]) <= 0
                              for k in range(4)),
                          f"conv yardstick disagrees with the kernel: {d}")
                    lib_ms = timer.ms(lambda: F.conv2d(xp, wt))
                    print(f"library yardstick: F.conv2d {tuple(xp.shape)} * "
                          f"{tuple(wt.shape)} = {lib_ms:.4f} ms "
                          f"(max |diff| vs kernel {d!r})")
                    entries["tap_window"] = dict(
                        ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                        library_ms=lib_ms)
                    del xp, got, ours
            del planes
    times = _time_transforms(torch, R, PP, device, plans, x, timer)
    # the fused-pyramid kernels at the main path's pyramid
    print("kernel,image,block,smem,kernel_ms,plain_ms,unique_bytes,"
          "unique_GB/s,model_bytes,model_GB/s,bound_ms,bound_by,"
          "bound_share,ops,term_evals,levels_ms,grid,blocks_per_sm,"
          "scratch_bytes")
    plan = plans[("ns-polyconv", "pyramid")]
    spec = plan.pyramid
    h, w = x.shape[-2:]
    pyr = R.dwt2(x, scheme="ns-polyconv", fuse="pyramid",
                 wavelet=MAIN["wavelet"], levels=MAIN["levels"],
                 device=device)
    ll = pyr.ll.contiguous()
    det = tuple(tuple(d.contiguous() for d in t) for t in pyr.details[::-1])
    for name, pw, run, ref, levels_ms in (
            ("pyramid_forward", spec.fwd_kernel,
             lambda: PW.pyramid_forward(spec.fwd_kernel, x),
             lambda: PW.pyramid_forward_ref(spec.fwd_kernel, x),
             times[("ns-polyconv", "levels", "cuda")][0]),
            ("pyramid_inverse", spec.inv_kernel,
             lambda: PW.pyramid_inverse(spec.inv_kernel, ll, det),
             lambda: PW.pyramid_inverse_ref(spec.inv_kernel, ll, det),
             times[("ns-polyconv", "levels", "cuda")][1])):
        k_ms = timer.ms(run)
        kernel = PW.FORWARD if name == "pyramid_forward" else PW.INVERSE
        grid, per_sm = kernel.last_grid
        p_ms = timer.ms(ref, reps=5, warmup=1)
        nb = _pyramid_bytes(PP, pw, h, w)
        scratch = sum(b * (h >> (l + 1)) * (w >> (l + 1))
                      for l in range(pw.levels - 1)) * 4
        block = "/".join(f"{a}x{c}" for a, c in pw.level_blocks)
        unique, modelled = nb.unique * b, nb.modelled * b
        ops = sum((p.stats()["muls"] + p.stats()["adds"]) * b
                  * (h >> (l + 1)) * (w >> (l + 1))
                  for l, p in enumerate(pw.programs))
        t_bytes = unique / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"{name},{b}x{h}x{w},{block},"
              f"{pw.smem_bytes},{k_ms:.4f},{p_ms:.4f},{unique},"
              f"{unique / k_ms / 1e6:.1f},{modelled},"
              f"{modelled / k_ms / 1e6:.1f},{bound:.4f},{by},"
              f"{bound / k_ms:.4f},{ops},{pw.term_evaluations((b, h, w))},"
              f"{levels_ms:.4f},{grid},{per_sm},{scratch}")
        entries[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                             bound_by=by, library_ms=None,
                             levels_ms=levels_ms)
    print("(no one PyTorch call computes a multi-level pyramid: K2/K3's "
          "library_ms is null; levels_ms is the port's own fuse='levels' "
          "dwt2/idwt2 on backend cuda)")
    del pyr, ll, det
    check("tap_window" in entries, "fused level was not timed")
    return entries


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at tiny sizes through "
                         "the plain versions (no kernel, no timings kept)")
    args = ap.parse_args(argv)
    import torch
    cpu = args.cpu_rehearsal
    if not cpu and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card (or --cpu-rehearsal)", file=sys.stderr)
        return 2
    import repro_torch as R
    from repro_torch import compiler as C
    from repro_torch.compiler import conv as CV
    from repro_torch.kernels import polyphase as PP
    from repro_torch.kernels import pyramid_window as PW
    from repro_torch.kernels import tap_window as TW
    device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0) if not cpu else 'cpu'}",
          flush=True)
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    phase_build(TW, PW, cpu)
    max_err = {"tap_window": phase_kernel(torch, C, TW, device, cpu, gen)}
    worst = phase_pyramid_kernel(torch, R, PW, device, cpu, gen)
    max_err.update(pyramid_forward=worst["pyramid_forward"],
                   pyramid_inverse=worst["pyramid_inverse"])
    launched, plans, x = phase_main(torch, R, TW, PW, device, cpu, gen)
    timer = Timer(torch, device)
    launched["tap_window"] += phase_workloads(torch, R, TW, PW, CV, device,
                                              cpu, gen, x, timer)
    if not cpu:
        want = {"tap_window": 2 * sum(
            v for k, v in EXPECTED_LAUNCHES.items() if k[1] != "pyramid")
            + 2 * sum(PACKET_LAUNCHES.values())
            + 2 * sum(DWT3_LAUNCHES.values()),
            "pyramid_forward": 1, "pyramid_inverse": 1}
        check(launched == want, f"main path launched {launched}, expected "
                                f"{want}")
    entries = phase_times(torch, R, PP, TW, PW, CV, device, plans, x, timer)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    card = "cpu rehearsal" if cpu else nvidia_smi()
    print(card)
    kernels_line = [dict(name=name, route="cuda", source=SOURCES[name],
                         replaces=TPU_KERNELS[name],
                         launches=launched[name], max_abs_err=max_err[name],
                         **entries[name])
                    for name in ("tap_window", "pyramid_forward",
                                 "pyramid_inverse")]
    print(json.dumps({"kernels": kernels_line}))
    kind = "cpu" if cpu else torch.cuda.get_device_name(0)
    count = 0 if cpu else torch.cuda.device_count()
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if cpu else "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
