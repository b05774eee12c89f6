#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — builds ``src/repro_torch/csrc/tap_window.cu`` with nvcc for
             sm_90a and prints the build time and ``-Xptxas -v`` output;
2. kernel  — the window kernel against its plain version
             (``tap_window_ref``) on the same CUDA tensors, for every
             wavelet x scheme x optimize x fuse x direction x tap_opt, on
             batched non-smooth planes (37x53, 24x509) and on the main
             path's plane shapes; float32 must agree bit for bit
             (max |diff| = 0), float16/bfloat16 I/O and bfloat16 compute
             within the bounds below;
3. main    — ``repro_torch.dwt2`` / ``idwt2`` at B=8, 2048x2048, float32,
             3 levels, cdf97 on backend "cuda": ns-polyconv at fuse
             "none" and "scheme", sep-lifting at "none".  The launch
             counter must grow by exactly ``plan.launches`` per transform,
             the round trip must hold to ROUNDTRIP_TOL and the
             coefficients must agree with backend "torch" to CROSS_TOL;
             a small input must agree with the filter-bank oracle;
4. times   — CUDA events after warm-up, median of 7 runs: per launch and
             per transform, kernel vs plain version vs torch backend,
             bytes, GB/s and the bound (bytes / 3.35 TB/s against
             operations / 67 TFLOP/s); the library yardstick is one
             F.conv2d of the composed filter bank of the fused level
             (cuDNN with TF32 off);
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
                ("sep-lifting", "none"))
EXPECTED_LAUNCHES = {("ns-polyconv", "none"): 6,
                     ("ns-polyconv", "scheme"): 3,
                     ("sep-lifting", "none"): 24}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
REPS = 7
TPU_KERNEL = "src/repro/kernels/polyphase.py:203"


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


def phase_build(TW, cpu):
    print("== phase 1: build", flush=True)
    if cpu:
        print("cpu rehearsal: kernel not built (no nvcc on this machine)")
        return
    t0 = time.perf_counter()
    TW.KERNEL.library()
    print(f"built {TW.KERNEL.path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {TW.KERNEL.build_seconds})")
    for line in TW.KERNEL.ptxas_log.splitlines():
        if any(k in line for k in ("Compiling", "registers", "spill",
                                   "smem")):
            print("  ptxas:", line.strip())


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


def phase_main(torch, R, TW, device, cpu, gen):
    """The port's main path; returns (launches counted, plans, x)."""
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
    plans = {}
    TW.KERNEL.launches = 0
    counted = 0
    for scheme, fuse in MAIN_CONFIGS:
        plan = R.get_plan(shape=tuple(x.shape), scheme=scheme, fuse=fuse,
                          backend="cuda", **common)
        plans[(scheme, fuse)] = plan
        check(plan.launches == EXPECTED_LAUNCHES[(scheme, fuse)],
              f"{scheme}/{fuse}: plan.launches {plan.launches}")
        before = TW.KERNEL.launches
        pyr = R.dwt2(x, scheme=scheme, fuse=fuse, backend="cuda", **common)
        fwd = TW.KERNEL.launches - before
        rec = R.idwt2(pyr, scheme=scheme, fuse=fuse, backend="cuda",
                      device=device, wavelet=wav)
        inv = TW.KERNEL.launches - before - fwd
        if device.type == "cuda":
            torch.cuda.synchronize()
            check(fwd == plan.launches and inv == plan.launches,
                  f"{scheme}/{fuse}: counted {fwd} forward / {inv} inverse "
                  f"launches, plan says {plan.launches}")
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
        print(f"{scheme:12s} fuse={fuse:6s} launches fwd {fwd} inv {inv} "
              f"(plan {plan.launches}); round trip max |diff| "
              f"{max_abs(rec, x)!r}; vs torch backend max |diff| {cross!r}")
        del pyr, rec, ref, planes, ref_planes
    counted = TW.KERNEL.launches
    print(f"main path: {counted} window-kernel launches")
    return counted, plans, x


def phase_times(torch, R, PP, TW, CV, device, plans, x, timer):
    """Per-launch and per-transform times; returns the kernels-line entry
    measured on the fused level (ns-polyconv, fuse=scheme, level 0)."""
    print("== phase 4: times (median of %d, CUDA events)" % REPS, flush=True)
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("cudnn.allow_tf32 = False, cuda.matmul.allow_tf32 = False")
    print("config,level,launch,planes,halo,block,smem,kernel_ms,plain_ms,"
          "bytes,GB/s,bound_ms,bound_by,ops")
    b = x.shape[0]
    entry = None
    for (scheme, fuse), plan in plans.items():
        for spec in plan.level_specs:
            hp, wp = spec.plane_shape
            planes = _planes(torch, torch.Generator().manual_seed(7),
                             (b, hp, wp), torch.float32, device)
            for i, win in enumerate(spec.fwd_windows):
                k_ms = timer.ms(lambda: TW.tap_window(win, planes))
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
                      f"{nbytes / k_ms / 1e6:.1f},{bound:.4f},{by},{ops}")
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
                    entry = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                 bound_by=by, library_ms=lib_ms)
                    del xp, got, ours
            del planes
    print("config,transform,backend,launches,ms,image_GB/s,model_bytes,"
          "model_bound_ms")
    for (scheme, fuse), plan in plans.items():
        common = dict(wavelet=MAIN["wavelet"], scheme=scheme, fuse=fuse,
                      device=device)
        # modelled bytes of the kernel path: every launch's windows and
        # outputs plus the split/merge copy, summed over the levels
        model = {op: sum(PP.scheme_hbm_bytes(getattr(spec, f"{op}_programs"),
                                             spec.image_shape, 4, spec.block)
                         for spec in plan.level_specs) * b
                 for op in ("fwd", "inv")}
        for backend in ("cuda", "torch"):
            pyr = R.dwt2(x, backend=backend, levels=MAIN["levels"], **common)
            f_ms = timer.ms(lambda: R.dwt2(x, backend=backend,
                                           levels=MAIN["levels"], **common),
                            reps=5, warmup=1)
            i_ms = timer.ms(lambda: R.idwt2(pyr, backend=backend, **common),
                            reps=5, warmup=1)
            n = plan.launches if backend == "cuda" else 0
            gb = x.numel() * 4 / 1e6
            for op, t_ms, key in (("dwt2", f_ms, "fwd"),
                                  ("idwt2", i_ms, "inv")):
                print(f"{scheme}/{fuse},{op},{backend},{n},{t_ms:.4f},"
                      f"{gb / t_ms:.1f},{model[key]},"
                      f"{model[key] / HBM_BYTES_PER_S * 1e3:.4f}")
            del pyr
    check(entry is not None, "fused level was not timed")
    return entry


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
    from repro_torch.kernels import tap_window as TW
    device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0) if not cpu else 'cpu'}",
          flush=True)
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    phase_build(TW, cpu)
    max_err = phase_kernel(torch, C, TW, device, cpu, gen)
    launches, plans, x = phase_main(torch, R, TW, device, cpu, gen)
    if not cpu:
        check(launches == 2 * sum(EXPECTED_LAUNCHES.values()),
              f"main path counted {launches} launches")
    timer = Timer(torch, device)
    entry = phase_times(torch, R, PP, TW, CV, device, plans, x, timer)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    card = "cpu rehearsal" if cpu else nvidia_smi()
    print(card)
    kernels = [dict(name="tap_window", route="cuda",
                    source="src/repro_torch/csrc/tap_window.cu",
                    replaces=TPU_KERNEL, launches=launches,
                    max_abs_err=max_err, **entry)]
    print(json.dumps({"kernels": kernels}))
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
