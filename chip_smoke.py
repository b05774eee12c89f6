#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py                  # needs one CUDA device
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain versions, CPU

Phases, each of which fails the run (non-zero exit, no result line):

1. build   — builds ``src/repro_torch/csrc/tap_window.cu`` (the window
             kernel K1), ``pyramid_window.cu`` (the fused-pyramid
             kernels K2/K3), ``temporal_lift.cu`` (the 3-D transform's
             temporal pass) and ``rev_lift.cu`` (a level of the lossless
             5-3) with nvcc for sm_90a, all at once, and prints
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
2c. temporal — the temporal lifting kernel against the plain pass
             (``compiler/temporal.py``) for every wavelet, forward and
             inverse, float32/float16/bfloat16 I/O with float32 and
             bfloat16 compute, T of 2, 4, 466 and 1864 frames, planes
             with W not a multiple of 4, batch dims, a strided view
             along T and a transposed plane (launched on a contiguous
             copy): max |diff| 0 in every dtype (the same arithmetic);
             then the same comparison and its time at the volume cell's
             level-0 shape (1864x512x512 float32, 9/7), forward and
             inverse, beside its bytes bound and the plain pass's time;
2d. reversible — the reversible lifting kernel (``rev_lift.cu``, one
             level of the lossless 5-3 of ISO/IEC 15444-1 Annex F on int32
             images) against the plain integer path
             (``core/reversible.py``) on the same tensors, forward and
             inverse, at odd tile counts, partial tiles, 2-sample edges and
             batch dims; then ``dwt2``/``idwt2`` of the lossless cell's
             series (1871x512x512 int32, 5 levels) on backend "cuda": 10
             launches, every level's subbands against the plain path and
             the reconstruction equal to the input (max |diff| 0 each),
             with the kernel's and the plain path's times at level 0;
2e. plane fold — K1 reading a level's image (the split folded into its
             gather) and writing it back (the merge folded into its sink)
             against the plane layout (the planes copied contiguous, the
             output interleaved by ``from_planes``) and against the plain
             version, level by level at ns-polyconv "none" and "scheme":
             the slice cell's request (932x512x512 float32, 5 levels), one
             temporal half-band of the volume cell's (1864x512x512 through
             the temporal lifting kernel, 932x512x512, 3 levels) and a
             3x148x212 image at 2 levels (ragged tiles), plus float16/
             bfloat16 I/O
             and bfloat16 compute and planes narrower than the halo at
             tiny sizes: max |diff| 0 everywhere; then K1's level-0
             launches at the slice cell's shape timed in both layouts
             (the forward's first, the inverse's last), and one request of
             each K1 cell through ``dwt2``/``idwt2`` and ``dwt3``/
             ``idwt3``: ``repro_plane_folds_total`` 5 + 5 and 6 + 6, no
             plane-copy bytes, 20 and 24 K1 launches;
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
             3 levels (12 and 6, and 3 temporal lifting launches;
             ``plan.fallback`` names the unfused temporal pass);
             ``dwt2``/``idwt2`` of the main path on
             backend "conv" (ns-polyconv "none" and "levels",
             sep-lifting "none": 6, 3 and 24 ``F.conv2d`` calls), run
             before phase 4 turns TF32 off and checked to leave cuDNN's
             TF32 setting as it found it.  Results within CROSS_TOL of
             backend "torch", round trips within ROUNDTRIP_TOL;
             ``wpt2(packet="dwt:3")`` equal to ``dwt2(levels=3)`` bit for
             bit; ``best_basis`` (depth 2, shannon) the same tree on
             "cuda" and "torch", and that tree round-trips.  Times
             (median of 5) beside backend "torch" (and, for the conv
             path, "cuda"), the temporal pass alone at level 0 (kernel
             and plain version), and K1's launches per path;
3d. telemetry — the telemetry and fault planes at the main path's width
             (ns-polyconv "pyramid", "levels", "none"): in "spans" mode
             inside ``torch.profiler``, ``execute.*`` must hold one
             ``pyramid.launch`` or three ``level.*`` spans, all timed on
             the card, with every K1/K2/K3 launch inside its span in the
             profiler trace and both Chrome traces valid JSON (written to
             ``build/chip_smoke/``); the live roofline at most
             3,350 GB/s and within 2x of a CUDA-event median over the same
             ``plan.executor.hbm_bytes`` (spans and events both around
             calls made back to back; the roofline read after five: the
             newest, and the ring's median); the same count of
             synchronising calls in "off", "counters" and "spans" (sync
             debug mode); recovery — ``pyramid.launch=raise:always``
             degrades to cuda/levels, bit for bit, K1 +3, K2 +0, the
             phase's one fallback; ``execute.forward=corrupt:once``
             retried once, bit for bit; ``torch/none`` exhausts the
             chain; resilience off fails fast; and the overhead of each
             mode, on the card and on the host.  Phases 2, 2b, 3, 3c,
             3e and 4, and each step of 3d but the recovery, end with no
             fallback counted (``repro_fallbacks_total``, read directly:
             it counts in every telemetry mode);
3e. tiling — the main path's images over a 4x4 grid of 512^2 tiles
             (margin 32, 576^2 windows) at ns-polyconv "none", "levels"
             and "pyramid", and a 6x6 overhanging grid of 384^2 tiles at
             sep-lifting dd137 "levels": tiled ``dwt2``/``idwt2`` against
             the monolithic ones (max |diff| printed, CROSS_TOL held, bit
             for bit expected), exact launches (K1 6 / 3, one K2 or K3),
             the round trip, and a second call hitting the cache for the
             tiled plan and its window plan; ``stream_dwt2`` of a 1 GiB
             16384^2 memmapped image written under ``build/chip_smoke/``
             (1024^2 tiles, ``max_inflight=2``) against the monolithic
             ``dwt2``, with its peak device memory below the image's
             size, every staging buffer pinned and at most one
             synchronising call per band; on a 4096^2 image the band
             checkpoint killed after two bands and resumed bit for bit,
             ``stream.host_gather`` / ``stream.drain`` faults retried to
             a clean result, ``stream.h2d_dispatch`` failing fast, and a
             ``tiling.halo_gather`` fault on a tiled pyramid retried
             once; then tiled beside monolithic times (back-to-back CUDA
             events, median of 21) split into the ``tile.*`` device
             spans, with the modelled bytes;
3f. serving — the profiler, ``backend="auto"`` and a ``DwtServer`` on
             2048x2048 fp32 images (cdf97, ns-polyconv, 3 levels), with
             the store and block table in ``build/chip_smoke/phase3f/``:
             an empty store resolves "auto" cold to cuda/pyramid; the
             store is warmed over every candidate (cuda none/scheme/
             levels/pyramid, conv none/scheme/levels, torch's four) at
             batches 1, 2, 4, 8 (median of 5 back-to-back synchronised
             calls, one row per record with its spread and modelled
             bytes); every batch size then resolves from the store at
             the records' argmin; an unseen 8x1024x1024 shape resolves
             from the model, printed beside a measurement and
             ``repro_model_time_ratio``; a two-worker server answers 32
             dwt2 and 32 idwt2 requests, each equal to a direct dwt2 of
             its image at the resolved configuration bit for bit (to
             CROSS_TOL on "conv") and round-tripping, with 0 plan-cache
             misses after warmup, p50/p99, img/s and occupancy, and the
             ``serve.*`` spans of a batch; a worker killed mid-burst (all
             served, one replacement); a block-table sweep (three
             targets at "levels", the fastest saved, the rebuilt plan at
             its blocks, outputs compared with the default block's, a
             foreign-fingerprint entry skipped and counted); and a
             ``torch.profiler`` trace of a warmed server holding one
             pinned host-to-device copy per forward batch;
3g. LM     — the dense LM training path: qwen2-0.5b at full width and
             depth (501M parameters, 14 stacked leaves; the SMOKE config
             under --cpu-rehearsal), seq 4096, global batch 4 as 2
             microbatches, SyntheticSource seed 0, through
             ``repro_torch.runtime.steps.train_step``: 4 steps with
             grad_compression "dwt:2" (cdf97) and 2 without, every loss
             finite, K1 launched exactly as the compression plans say
             (``plan.launches`` of each leaf's forward and inverse plan
             per step), per-step device spans (``train.grads``,
             ``train.compress`` and its DWT ``execute.*``, ``train.adamw``),
             tokens/s and peak device memory; on one step's real
             gradients every K1 launch of compress/decompress against
             its plain version bit for bit, ``g_hat`` against the same
             transforms on backend "torch" to CROSS_TOL, each slice 1/16
             of its padded tile, and K1's share of compression (CUDA
             events around each launch); prefill of 16 tokens and one
             decode step against forward within 2e-2; a restart through
             ``train_loop.train`` at full width cut to 2 layers (3 steps,
             a checkpoint per step in ``build/chip_smoke/phase3g/``,
             deleted after; step 1's restored) replaying step 3's loss
             within 1e-5 relative;
3h. families — the MoE, RWKV6, Mamba2-hybrid and Whisper families at
             their published widths, depth cut to fit one card beside
             their fp32 state (``FAMILIES``: mixtral-8x7b 1 of 32 layers,
             rwkv6-3b 2 of 32 at seq 1024, zamba2-2.7b 12 of 54 with 2
             shared-attention invocations, whisper-medium whole; seq 4096,
             global batch 4 in the microbatches listed; the SMOKE configs
             under --cpu-rehearsal), each in turn after the last one's
             state is freed: 2 steps with grad_compression "dwt:2"
             (cdf97) and 1 without, every loss finite and the MoE aux
             loss above 0, K1 launched exactly as the compression plans
             say, every tile within K1's int32 index math, the
             ``train.*`` device spans, tokens/s and peak memory; one
             profiled compressed step; every K1 launch of one step's
             compression against its plain version bit for bit
             (mixtral's (1835008, 256) expert tiles included) and
             ``g_hat`` against backend "torch" to CROSS_TOL; prefill +
             decode (whisper: its prefill + 4 decode steps) against the
             forward within the reference's 2e-2 (moe, encdec) / 8e-2
             (ssm, hybrid) in float32 compute, the bfloat16 difference
             printed beside it;
3i. multi-device — qwen2-0.5b at 3g's cut over a one-rank NCCL process
             group (``file://`` rendezvous under ``build/``) and the
             ``(pod=1, data=1, model=1)`` mesh of
             ``launch.mesh.make_debug_mesh``: 2 plain ``train_step`` calls,
             2 sharded steps (the state and batch DTensors placed by the
             rules, on the single-pod (data, model) sub-mesh) and 2
             podwise steps (``make_train_step_podwise``) from one seeded
             state and the same 2 batches; losses, every parameter and
             every error-feedback leaf bit for bit against the plain
             steps; K1 launches per step = the plans' sum (112), one
             podwise step's against the plain version bit for bit; the
             pod all-reduce's bytes = the compressed slices' sum, beside
             the float32 gradient bytes; the ``train.*`` spans of the
             plain and the podwise step (``train.pod_reduce`` included);
             then the dry run (``repro_torch.launch.dryrun`` over a fake
             256/512-rank group, one process per cell, all at once):
             qwen2-0.5b ``train_4k`` sharded on 16x16 and podwise on
             2x16x16, argument bytes alone for its sharded step on
             2x16x16 and for dbrx-132b (``DRYRUN_CELLS``); each cell's
             per-device bytes, FLOPs, wire bytes and dominant term on the
             H100's constants (gloo, SMOKE sizes and the dry run's
             ``--smoke`` under --cpu-rehearsal);
3j. entry points — the direct scheme oracles (``schemes.forward`` and
             ``optimize.forward_optimized``, 3 wavelets x 6 schemes) on
             one 2048^2 float32 image within CROSS_TOL of ``dwt2(levels=1,
             backend="cuda")`` and of sep-lifting's forward, the Section 5
             op counts printed beside the raw ones; then each module of
             ``repro_torch.examples`` on the card, every counter at 0
             before it and K1's launches exact after it: the quickstart
             at 256^2 (round trips within ROUNDTRIP_TOL, LLs within
             CROSS_TOL of the first scheme's, counts equal to a CPU run's,
             ``apply_scheme_cuda`` against its plain version bit for bit,
             the batched "levels" plan 3 launches and a cache hit); the
             codec's 512^2 PSNR sweep, its out-of-core path on an 8192^2
             memmap (1024^2 tiles, 4 levels: the streamed pyramid equal
             to the monolithic ``dwt2`` bit for bit, the keep-share PSNRs
             within 0.01 dB of the monolithic path's) and its served path
             (64 tiles of 64^2, each equal to direct ``dwt2``/``idwt2``
             bit for bit; batches and occupancy); ``train_lm`` at its
             defaults (qwen2-100m, batch 8, seq 256, 300 steps) plain and
             compressed (losses finite and decreasing, K1 per step = the
             compression plans' launches, one step's K1 against its plain
             version bit for bit, checkpoints 100/200/300 committed; ms per
             step, tokens/s, peak memory, the final-loss gap); the
             compression demo (minitron-8b SMOKE, 120 steps x none/dwt:2/
             dwt:1: byte lines exact, all three decreasing, both gaps);
             ``serve_lm`` on mixtral-8x7b SMOKE and qwen2-0.5b at full
             width and depth (batch 4, prompt 32, 32 new tokens: the
             teacher-forced logits of every step against one forward
             within 2e-2 in float32 compute, the configured dtype's
             difference and largest |logit| printed; ms per token); each
             step's time (tiny sizes and SMOKE configs under
             --cpu-rehearsal);
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

``python3 chip_smoke.py --host-overhead SRC [SRC ...]`` runs only phase
3d's host-overhead step, for the ``repro_torch`` package of each ``SRC``
(say ``build/parent/src src``: a parent's checkout, timed as it is when
it has no telemetry, and this one), all held in one process and timed
round by round, so that two trees compare on one card and one host.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
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
# phase 3e: the main path's images over a 4x4 grid of 512^2 tiles (and a
# 6x6 overhanging grid of 384^2), a 1 GiB memmapped image streamed in
# 1024-row bands, a 4-band checkpointed stream
TILED = dict(tiles=(512, 512), margin=32, overhang=(384, 384))
TILED_LAUNCHES = {"none": (6, 0), "levels": (3, 0), "pyramid": (0, 1)}
STREAM = dict(size=16384, tiles=(1024, 1024), max_inflight=2,
              fault_seed=3)
CHECKPOINT = dict(size=4096, tiles=(1024, 1024))
TIMING_REPS = 21
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
REPS = 7
TPU_KERNELS = {"tap_window": "src/repro/kernels/polyphase.py:203",
               "pyramid_forward": "src/repro/kernels/polyphase.py:385",
               "pyramid_inverse": "src/repro/kernels/polyphase.py:493",
               "temporal_lift": "none: the reference runs the pass as jnp "
                                "between its Pallas kernels "
                                "(src/repro/compiler/temporal.py)",
               "rev_lift": "none: the reference has no integer path"}
SOURCES = {"tap_window": "src/repro_torch/csrc/tap_window.cu",
           "pyramid_forward": "src/repro_torch/csrc/pyramid_window.cu",
           "pyramid_inverse": "src/repro_torch/csrc/pyramid_window.cu",
           "temporal_lift": "src/repro_torch/csrc/temporal_lift.cu",
           "rev_lift": "src/repro_torch/csrc/rev_lift.cu"}
# phase 2c: the kernel's shapes (T of 2, 4, 466 and 1864; W not a
# multiple of 4; batch dims) and its timing at the volume cell's level 0
TEMPORAL_SHAPES = ((2, 5, 7), (3, 4, 6, 10), (466, 9, 13), (2, 1864, 3, 7))
TEMPORAL_DTYPES = (("float32", "float32"), ("float16", "float32"),
                   ("bfloat16", "float32"), ("float32", "bfloat16"),
                   ("bfloat16", "bfloat16"), ("float16", "bfloat16"))
TEMPORAL_TIMED = (1864, 512, 512)
# phase 2d: the reversible kernel's shapes (partial tiles, H or W of 2,
# batch dims) and the lossless cell's series
REVERSIBLE_SHAPES = ((1, 2, 2), (2, 4, 6), (3, 66, 130), (5, 96, 200),
                     (2, 2, 1026), (1, 1030, 6), (2, 3, 64, 64))
REVERSIBLE_TIMED = (1871, 512, 512)
REVERSIBLE_LEVELS = 5
# phase 2e: the K1 cells' requests (slice2d's images, vol3d's volume and
# its temporal half-band), their levels, and the small cases
FOLD_SLICES, FOLD_SLICE_LEVELS = (932, 512, 512), 5
FOLD_VOLUME, FOLD_VOLUME_LEVELS = (1864, 512, 512), 3
FOLD_SMALL = (((3, 148, 212), 2), ((2, 6, 10), 1), ((2, 3, 8, 12), 2))
FOLD_NARROW = (("float16", "float32"), ("bfloat16", "float32"),
               ("float32", "bfloat16"), ("bfloat16", "bfloat16"))


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

    def back_to_back_ms(self, fn, reps=REPS, warmup=2):
        """Median of ``reps`` calls made back to back, each between two
        CUDA events, nothing waited for until the last: a call's start
        event fires when the card has finished the call before it (as a
        span's does), not while the host is still enqueueing."""
        torch = self.torch
        if not self.cuda:
            return self.ms(fn, reps, warmup)
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        pairs[-1][1].synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def kernels(TW, PW):
    """Every kernel of the main path: name -> its launch counter."""
    return {"tap_window": TW.KERNEL, "pyramid_forward": PW.FORWARD,
            "pyramid_inverse": PW.INVERSE}


def phase_build(TW, PW, TL, RL, cpu):
    print("== phase 1: build", flush=True)
    if cpu:
        print("cpu rehearsal: kernels not built (no nvcc on this machine)")
        return
    libs = (TW.LIBRARY, PW.LIBRARY, TL.LIBRARY, RL.LIBRARY)
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


def phase_temporal_kernel(torch, TL, device, cpu, gen, timer):
    """The temporal lifting kernel vs the plain pass, then its time at
    the volume cell's level 0; returns its kernels-line entry (largest
    |diff|, launches, times)."""
    print("== phase 2c: temporal lifting kernel vs plain pass", flush=True)
    from repro_torch.compiler import temporal as TP
    worst, n_cases, launches = 0.0, 0, 0
    t0 = time.perf_counter()
    for wav, (io, cdt) in itertools.product(WAVELETS, TEMPORAL_DTYPES):
        io, cdt = getattr(torch, io), getattr(torch, cdt)
        fwd, inv = (TP.compile_temporal(wav, i) for i in (False, True))
        vols = [torch.randn(s, generator=gen) for s in TEMPORAL_SHAPES]
        vols.append(torch.randn((2, 932, 9, 13), generator=gen)[:, 1::2])
        vols.append(torch.randn((6, 9, 13), generator=gen).mT)
        for v in vols:
            x = v.to(device=device, dtype=io)
            before = TL.KERNEL.launches
            lo, hi = TL.temporal_lift_forward(x, fwd, cdt)
            back = TL.temporal_lift_inverse(lo, hi, inv, cdt)
            want = TP.temporal_forward(x, fwd, cdt)
            got_n = TL.KERNEL.launches - before
            check(got_n == (0 if cpu else 2),
                  f"temporal_lift launched {got_n} times for 2 calls")
            launches += got_n
            for g, w in ((lo, want[0]), (hi, want[1]),
                         (back, TP.temporal_inverse(lo, hi, inv, cdt))):
                check(g.dtype == w.dtype and g.shape == w.shape,
                      f"temporal_lift output {g.dtype} {tuple(g.shape)} vs "
                      f"plain {w.dtype} {tuple(w.shape)}")
                d = max_abs(g, w)
                worst = max(worst, d)
                check(d == 0.0, f"temporal_lift disagrees with the plain "
                                f"pass: max |diff| {d} ({wav}, "
                                f"{tuple(x.shape)}, io {io}, compute {cdt})")
            n_cases += 1
    print(f"{n_cases} temporal kernel/plain comparisons (forward and "
          f"inverse) in {time.perf_counter() - t0:.1f} s: max |diff| "
          f"{worst!r}")
    # its time at the volume cell's level 0 (9/7, float32)
    shape = (4, 32, 32) if cpu else TEMPORAL_TIMED
    fwd, inv = (TP.compile_temporal("cdf97", i) for i in (False, True))
    x = torch.randn(shape, generator=gen).to(device)
    before = TL.KERNEL.launches
    lo, hi = TL.temporal_lift_forward(x, fwd)
    back = TL.temporal_lift_inverse(lo, hi, inv)
    launches += TL.KERNEL.launches - before
    # the many-chunk, full-width case bit for bit before it is timed
    want = TP.temporal_forward(x, fwd)
    d = max(max_abs(lo, want[0]), max_abs(hi, want[1]))
    del want
    d = max(d, max_abs(back, TP.temporal_inverse(lo, hi, inv)))
    del back
    worst = max(worst, d)
    check(d == 0.0, f"temporal_lift disagrees with the plain pass at "
                    f"{tuple(shape)}: max |diff| {d}")
    print(f"temporal_lift {'x'.join(map(str, shape))} cdf97 float32 "
          f"forward and inverse vs the plain pass: max |diff| {d!r}")
    nbytes = 2 * x.numel() * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = {}
    for op, run, plain in (
            ("forward", lambda: TL.temporal_lift_forward(x, fwd),
             lambda: TP.temporal_forward(x, fwd)),
            ("inverse", lambda: TL.temporal_lift_inverse(lo, hi, inv),
             lambda: TP.temporal_inverse(lo, hi, inv))):
        before = TL.KERNEL.launches
        k_ms = timer.ms(run)
        launches += TL.KERNEL.launches - before
        grid, per_sm = TL.KERNEL.last_grid
        p_ms = timer.ms(plain, reps=5, warmup=1)
        row[op] = (k_ms, p_ms)
        print(f"temporal_lift {op} {'x'.join(map(str, shape))} cdf97 "
              f"float32: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} "
              f"GB/s, {bound / k_ms:.4f} of the bound {bound:.4f} ms, "
              f"bytes), plain {p_ms:.4f} ms, chunks "
              f"{TL.encode(fwd).chunking(shape[0] // 2)}, grid {grid}, "
              f"{per_sm} blocks per SM")
    del x, lo, hi
    return dict(max_abs_err=worst, launches=launches,
                entry=dict(ms=row["forward"][0],
                           inverse_ms=row["inverse"][0],
                           plain_ms=row["forward"][1],
                           plain_inverse_ms=row["inverse"][1],
                           bound_ms=bound, bound_by="bytes",
                           library_ms=None))


def phase_reversible_kernel(torch, R, RL, device, cpu, gen, timer):
    """The reversible lifting kernel vs the plain integer path, then the
    lossless cell's series through ``dwt2``/``idwt2``; returns its
    kernels-line entry (largest |diff|, launches, times)."""
    print("== phase 2d: reversible lifting kernel vs plain path",
          flush=True)
    from repro_torch.core import reversible as RV

    def samples(shape):
        return torch.randint(-2048, 2048, shape, generator=gen,
                             dtype=torch.int32).to(device)

    worst, launches = 0.0, 0
    for shape in REVERSIBLE_SHAPES:
        x = samples(shape)
        before = RL.KERNEL.launches
        got = RL.rev_lift_forward(x)
        back = RL.rev_lift_inverse(got)
        n = RL.KERNEL.launches - before
        check(n == (0 if cpu else 2),
              f"rev_lift launched {n} times for 2 calls")
        launches += n
        want = RV.level_forward(x, "rev53")
        for g, w in zip(got + (back,),
                        want + (RV.level_inverse(want, "rev53"),)):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"rev_lift output {g.dtype} {tuple(g.shape)} vs plain "
                  f"{w.dtype} {tuple(w.shape)}")
            d = max_abs(g, w)
            worst = max(worst, d)
            check(d == 0.0, f"rev_lift disagrees with the plain path: max "
                            f"|diff| {d} at {shape}")
        check(torch.equal(back, x), f"rev_lift round trip of {shape} is "
                                    f"not exact")
    print(f"{len(REVERSIBLE_SHAPES)} reversible kernel/plain comparisons "
          f"(forward and inverse): max |diff| {worst!r}")
    shape = (4, 64, 64) if cpu else REVERSIBLE_TIMED
    L = REVERSIBLE_LEVELS
    kw = dict(wavelet="rev53", scheme="sep-lifting", boundary="symmetric",
              fuse="levels", backend="cuda", device=device)
    x = samples(shape)
    before = RL.KERNEL.launches
    pyr = R.dwt2(x, levels=L, **kw)
    rec = R.idwt2(pyr, **kw)
    n = RL.KERNEL.launches - before
    check(n == (0 if cpu else 2 * L),
          f"dwt2+idwt2 of rev53 launched rev_lift {n} times, expected "
          f"{2 * L}")
    launches += n
    check(torch.equal(rec, x), "rev53 round trip of the series is not "
                               "exact")
    del rec
    cur, d = x, 0.0
    for level in range(L):
        want = RV.level_forward(cur, "rev53")
        got = pyr.details[L - 1 - level]        # coarsest first
        d = max([d] + [max_abs(g, w) for g, w in zip(got, want[1:])])
        cur = want[0]
    d = max(d, max_abs(pyr.ll, cur))
    del cur, want, got
    worst = max(worst, d)
    check(d == 0.0, f"dwt2 of rev53 on 'cuda' disagrees with the plain "
                    f"path at {shape}: max |diff| {d}")
    print(f"rev53 dwt2+idwt2 {'x'.join(map(str, shape))} int32, {L} "
          f"levels: {n} rev_lift launches, every subband vs the plain "
          f"path max |diff| {d!r}, reconstruction exact")
    nbytes = 2 * x.numel() * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    bands = RL.rev_lift_forward(x)
    row = {}
    for op, run, plain in (
            ("forward", lambda: RL.rev_lift_forward(x),
             lambda: RV.level_forward(x, "rev53")),
            ("inverse", lambda: RL.rev_lift_inverse(bands),
             lambda: RV.level_inverse(bands, "rev53"))):
        before = RL.KERNEL.launches
        k_ms = timer.ms(run)
        launches += RL.KERNEL.launches - before
        grid, per_sm = RL.KERNEL.last_grid
        p_ms = timer.ms(plain, reps=3, warmup=1)
        row[op] = (k_ms, p_ms)
        print(f"rev_lift {op} level 0 {'x'.join(map(str, shape))} int32: "
              f"kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s, "
              f"{bound / k_ms:.4f} of the bound {bound:.4f} ms, bytes), "
              f"plain {p_ms:.4f} ms, grid {grid}, {per_sm} blocks per SM")
    before = RL.KERNEL.launches
    call_ms = {name: timer.ms(run, reps=5) for name, run in (
        ("dwt2", lambda: R.dwt2(x, levels=L, **kw)),
        ("idwt2", lambda: R.idwt2(pyr, **kw)))}
    launches += RL.KERNEL.launches - before
    print(f"rev53 {L}-level calls on 'cuda': dwt2 {call_ms['dwt2']:.4f} "
          f"ms, idwt2 {call_ms['idwt2']:.4f} ms (one call between CUDA "
          f"events)")
    del x, pyr, bands
    return dict(max_abs_err=worst, launches=launches,
                entry=dict(ms=row["forward"][0],
                           inverse_ms=row["inverse"][0],
                           plain_ms=row["forward"][1],
                           plain_inverse_ms=row["inverse"][1],
                           bound_ms=bound, bound_by="bytes",
                           library_ms=None))


def _fold_level(torch, PP, TW, S, x, spec):
    """One level of ``x`` both ways through K1 in the image layout (the
    engine's path), in the plane layout (the planes copied contiguous,
    the inverse's output interleaved by ``from_planes``) and through the
    plain version; returns (largest |diff|, the level's planes)."""
    def planes_of(img):
        return [p.reshape((-1,) + p.shape[-2:]).contiguous()
                for p in S.to_planes(img)]

    def chain(run, planes, windows):
        for win in windows:
            planes = run(win, planes)
        return planes

    got = PP.apply_steps_cuda(spec.fwd_steps, x, windows=spec.fwd_windows)
    flat = [g.reshape((-1,) + g.shape[-2:]) for g in got]
    worst = 0.0
    for run in (TW.tap_window, TW.tap_window_ref):
        want = chain(run, planes_of(x), spec.fwd_windows)
        worst = max([worst] + [max_abs(a, b) for a, b in zip(flat, want)])
    back = PP.apply_steps_cuda(spec.inv_steps, got, windows=spec.inv_windows,
                               image_out=True)
    for run in (TW.tap_window, TW.tap_window_ref):
        want = S.from_planes(chain(run, flat, spec.inv_windows))
        worst = max(worst, max_abs(back.reshape(want.shape), want))
    check(back.shape == x.shape and all(g.shape[:-2] == x.shape[:-2]
                                        for g in got),
          f"image layout shapes {tuple(back.shape)} / "
          f"{[tuple(g.shape) for g in got]} for an image {tuple(x.shape)}")
    return worst, got


def _fold_levels(torch, R, PP, TW, S, x, levels, fuse, device, cdt):
    """:func:`_fold_level` down ``levels`` levels of ``x`` (each level on
    the LL of the one before); returns the largest |diff|."""
    plan = R.get_plan(shape=tuple(x.shape), levels=levels,
                      scheme="ns-polyconv", fuse=fuse, backend="cuda",
                      dtype=str(x.dtype).split(".")[-1], compute_dtype=cdt,
                      device=device)
    worst = 0.0
    for spec in plan.level_specs:
        d, planes = _fold_level(torch, PP, TW, S, x, spec)
        worst = max(worst, d)
        x = planes[0]
    return worst


def phase_plane_fold(torch, R, PP, TW, TL, device, cpu, gen, timer):
    """K1 in the image layout vs the plane layout and the plain version,
    its level-0 times in both layouts, and the fold counters of one
    request of each K1 cell; returns K1's launches."""
    print("== phase 2e: K1 reading and writing the image (split and merge "
          "folded)", flush=True)
    from repro_torch.compiler import temporal as TP
    from repro_torch.core import schemes as S
    t0 = time.perf_counter()
    before = TW.KERNEL.launches
    slices = (4, 32, 32) if cpu else FOLD_SLICES
    volume = (8, 32, 32) if cpu else FOLD_VOLUME
    slice_levels = 2 if cpu else FOLD_SLICE_LEVELS
    volume_levels = 2 if cpu else FOLD_VOLUME_LEVELS
    images = [("slice2d request", torch.randn(slices, generator=gen)
               .to(device), slice_levels)]
    vol = torch.randn(volume, generator=gen).to(device)
    lo, hi = TL.temporal_lift_forward(vol, TP.compile_temporal("cdf97"))
    del vol, hi
    images.append(("vol3d half-band", lo, volume_levels))
    images += [("small", torch.randn(shape, generator=gen).to(device),
                levels)
               for shape, levels in FOLD_SMALL]
    worst = 0.0
    for (name, x, levels), fuse in itertools.product(images,
                                                     ("none", "scheme")):
        d = _fold_levels(torch, R, PP, TW, S, x, levels, fuse, device,
                         "float32")
        print(f"{name} {'x'.join(map(str, x.shape))} fuse {fuse!r}, "
              f"{levels} levels: image layout vs plane layout and plain "
              f"version: max |diff| {d!r}")
        worst = max(worst, d)
    for io, cdt in FOLD_NARROW:
        x = torch.randn((2, 6, 40), generator=gen).to(device,
                                                      getattr(torch, io))
        for fuse in ("none", "scheme"):
            d = _fold_levels(torch, R, PP, TW, S, x, 1, fuse, device, cdt)
            print(f"io {io}, compute {cdt}, fuse {fuse!r}: max |diff| "
                  f"{d!r}")
            worst = max(worst, d)
    check(worst == 0.0, f"K1's image layout disagrees with its plane "
                        f"layout or its plain version: max |diff| {worst}")
    print(f"image and plane layouts in {time.perf_counter() - t0:.1f} s: "
          f"max |diff| {worst!r}")
    # K1's level-0 launches at the slice cell's shape, both layouts
    x = images[0][1]
    spec = R.get_plan(shape=tuple(x.shape), levels=slice_levels,
                      scheme="ns-polyconv", fuse="none", backend="cuda",
                      device=device).level_specs[0]
    planes = [p.contiguous() for p in S.to_planes(x)]
    first, last = spec.fwd_windows[0], spec.inv_windows[-1]
    subbands = TW.tap_window(first, planes)
    rows = {}
    for name, run in (
            ("forward first, image in", lambda: TW.tap_window(first, x)),
            ("forward first, planes in",
             lambda: TW.tap_window(first, planes)),
            ("inverse last, image out",
             lambda: TW.tap_window(last, subbands, image_out=True)),
            ("inverse last, planes out",
             lambda: TW.tap_window(last, subbands))):
        rows[name] = timer.ms(run, reps=TIMING_REPS)
        print(f"K1 level 0 {name} {'x'.join(map(str, x.shape))}: "
              f"{rows[name]:.4f} ms")
    for a, b in (("forward first, image in", "forward first, planes in"),
                 ("inverse last, image out", "inverse last, planes out")):
        print(f"{a} / {b}: {rows[a] / rows[b]:.4f}")
    del planes, subbands
    # one request of each K1 cell: the counters
    launches = TW.KERNEL.launches - before
    for name, run, folds, k1 in (
            ("slice2d", lambda: R.idwt2(R.dwt2(
                x, levels=slice_levels, scheme="ns-polyconv", fuse="none",
                backend="cuda", device=device), scheme="ns-polyconv",
                fuse="none", backend="cuda", device=device),
             slice_levels, 4 * slice_levels),
            ("vol3d", lambda: R.idwt3(R.dwt3(
                torch.randn(volume, generator=gen).to(device),
                levels=volume_levels, scheme="ns-polyconv", fuse="none",
                backend="cuda", device=device), scheme="ns-polyconv",
                fuse="none", backend="cuda", device=device),
             2 * volume_levels, 8 * volume_levels)):
        n0 = TW.KERNEL.launches
        f0 = {op: PP.PLANE_FOLDS.value(op=op) for op in ("split", "merge")}
        b0 = sum(PP.PLANE_COPY_BYTES.value(op=op)
                 for op in ("split", "merge"))
        run()
        got = {op: PP.PLANE_FOLDS.value(op=op) - f0[op]
               for op in ("split", "merge")}
        copied = sum(PP.PLANE_COPY_BYTES.value(op=op)
                     for op in ("split", "merge")) - b0
        n = TW.KERNEL.launches - n0
        launches += n
        print(f"{name} request: repro_plane_folds_total {got}, plane copy "
              f"bytes {copied}, K1 launches {n}")
        check(got == {"split": folds, "merge": folds} and copied == 0,
              f"{name}: folds {got} (want {folds} each), copied {copied}")
        check(n == (0 if cpu else k1), f"{name}: {n} K1 launches")
    del images, x, lo
    return launches


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
    from repro_torch.kernels import temporal_lift as TL
    wav = MAIN["wavelet"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    counters = kernels(TW, PW)
    per_path, per_temporal = {}, {}

    def counted(name, run_fwd, run_inv, plan, temporal=0):
        """Run one path forward then inverse with every counter at 0;
        check K1's launches against ``plan.launches`` and the temporal
        lifting kernel's against ``temporal`` per direction."""
        for k in (*counters.values(), TL.KERNEL):
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
                  and not any(others.values())
                  and TL.KERNEL.launches == 2 * temporal,
                  f"{name}: counted {n_fwd} forward / {n_all - n_fwd} "
                  f"inverse K1 launches (others {others}, temporal_lift "
                  f"{TL.KERNEL.launches}), plan says {plan.launches} and "
                  f"{temporal} temporal a direction")
        per_path[name] = n_all
        per_temporal[name] = TL.KERNEL.launches
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
                                wavelet=wav, device=device), plan,
            temporal=L3)
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
    f3, i3 = d3[("cuda", "levels")]
    for what, fwd, inv in (
            ("kernel", lambda: TL.temporal_lift_forward(vol, fprog),
             lambda: TL.temporal_lift_inverse(lo, hi, iprog)),
            ("plain", lambda: TP.temporal_forward(vol, fprog),
             lambda: TP.temporal_inverse(lo, hi, iprog))):
        t_fwd = timer.ms(fwd, reps=5, warmup=1)
        t_inv = timer.ms(inv, reps=5, warmup=1)
        print(f"temporal pass ({what}) at level 0 of {shape3}: forward "
              f"{t_fwd:.4f} ms ({t_fwd / f3:.4f} of dwt3 cuda/levels "
              f"{f3:.4f} ms), inverse {t_inv:.4f} ms ({t_inv / i3:.4f} of "
              f"idwt3 {i3:.4f} ms)")
    del xp, vol, lo, hi
    print(f"temporal lifting launches per path (forward + inverse): "
          f"{ {k: v for k, v in per_temporal.items() if v} }")
    return sum(per_path.values()), sum(per_temporal.values())


SPAN_NAMES = ("execute.forward", "execute.inverse", "pyramid.launch",
              "level.forward", "level.inverse")
#: kernel names (demangled prefixes) of the profiler's device events
KERNEL_SYMBOLS = {"tap_window": "tap_window_kernel",
                  "pyramid_forward": "pyramid_forward_kernel",
                  "pyramid_inverse": "pyramid_inverse_kernel"}


def fallbacks():
    """Degradation-chain hops so far: ``repro_fallbacks_total`` read
    directly (it counts in every telemetry mode)."""
    from repro_torch.faults import degrade as DG
    return int(sum(row["value"] for row in DG.FALLBACKS.series()))


def no_fallbacks(where):
    """The fault plane never hides a kernel: outside phase 3d's own
    recovery checks no execution may have degraded."""
    n = fallbacks()
    check(n == 0, f"{where}: {n} executions degraded down the fallback "
                  f"chain (repro_fallbacks_total)")


def _profiled_kernels_inside(doc, span_names):
    """Each of our kernels' device events in a ``torch.profiler`` Chrome
    trace, with the span (``record_function`` range) it was launched in:
    the runtime call of the same correlation id inside the range on the
    host, or the kernel inside the range's projection on the device.
    Returns ``{kernel: [span name or None per launch]}``."""
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    host = [e for e in evs if e.get("cat") == "user_annotation"
            and e["name"] in span_names]
    dev = [e for e in evs if e.get("cat") == "gpu_user_annotation"
           and e["name"] in span_names]
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}

    def within(t0, t1, ranges):
        # the innermost range holding [t0, t1]
        inside = [r for r in ranges
                  if r["ts"] <= t0 and t1 <= r["ts"] + r["dur"]]
        return min(inside, key=lambda r: r["dur"])["name"] if inside \
            else None

    out = {}
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        name = next((k for k, sym in KERNEL_SYMBOLS.items()
                     if sym in e["name"]), None)
        if name is None:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        where = (within(call["ts"], call["ts"], host) if call is not None
                 else None) or within(e["ts"], e["ts"] + e["dur"], dev)
        out.setdefault(name, []).append(where)
    return out


def _package_modules():
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


def load_tree(src):
    """A checkout's ``repro_torch`` (``src`` is its ``src/``), imported
    afresh beside any other tree this process holds; run it inside
    :func:`tree_in_use`."""
    tree = {"src": str(src), "mods": {}}
    with tree_in_use(tree) as R:
        check(Path(R.__file__).resolve().is_relative_to(src),
              f"repro_torch imported from {R.__file__}, not {src}")
        try:
            importlib.import_module("repro_torch.telemetry")
            tree["modes"] = ("off", "counters", "spans")
        except ModuleNotFoundError:
            tree["modes"] = ("as_is",)      # a tree from before telemetry
    return tree


@contextlib.contextmanager
def tree_in_use(tree):
    """Swap ``tree``'s modules into ``sys.modules`` and its ``src`` onto
    the front of ``sys.path``, so that what it imports at call time is
    its own; yields its ``repro_torch``."""
    for name in _package_modules():
        del sys.modules[name]
    sys.modules.update(tree["mods"])
    sys.path.insert(0, tree["src"])
    try:
        yield importlib.import_module("repro_torch")
    finally:
        sys.path.remove(tree["src"])
        tree["mods"] = _package_modules()


def host_overhead(torch, trees, device, gen, rounds=201, batch=10):
    """Host time per ``plan.execute`` on an 8x64x64 input, the fault
    plane disarmed, at ``"none"`` and ``"pyramid"``, for every tree and
    each of its telemetry modes: ``rounds`` rounds, each timing ``batch``
    calls back to back in every (tree, mode) cell, the cells in an order
    rotated by one per round (``time.perf_counter``; the card is waited
    for after each batch, outside the clock); prints and returns the
    median µs per call over the rounds, ``{fuse: {src: {mode: µs}}}``."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    small = torch.randn((8, 64, 64), generator=gen).to(device)
    print(f"overhead (host): fuse,src,mode,us (per plan.execute on "
          f"8x64x64, perf_counter, median of {rounds} rounds of {batch} "
          f"calls, every cell in every round)")
    cells = [(t, m) for t in trees for m in t["modes"]]
    out = {}
    for fuse in ("none", "pyramid"):
        plans, per = {}, {}
        for t in trees:
            with tree_in_use(t) as R:
                plans[t["src"]] = plan = R.get_plan(
                    shape=tuple(small.shape), wavelet=MAIN["wavelet"],
                    scheme="ns-polyconv", levels=MAIN["levels"],
                    backend="cuda", fuse=fuse, device=device)
                for _ in range(2 * batch):
                    plan.execute(small)
                sync()
        for r in range(rounds):
            k = r % len(cells)
            for t, mode in cells[k:] + cells[:k]:
                with tree_in_use(t):
                    if mode != "as_is":
                        t["mods"]["repro_torch.telemetry"].set_mode(mode)
                    plan = plans[t["src"]]
                    t0 = time.perf_counter()
                    for _ in range(batch):
                        plan.execute(small)
                    dt = time.perf_counter() - t0
                    sync()
                per.setdefault(t["src"], {}).setdefault(mode, []).append(
                    dt / batch * 1e6)
        out[fuse] = {src: {m: statistics.median(v) for m, v in row.items()}
                     for src, row in per.items()}
        for src, row in out[fuse].items():
            for mode, us in row.items():
                print(f"{fuse},{src},{mode},{us:.2f}")
    for t in trees:
        if "repro_torch.telemetry" in t["mods"]:
            t["mods"]["repro_torch.telemetry"].set_mode("counters")
    return out


def phase_telemetry(torch, R, TW, PW, device, cpu, gen, x, timer):
    """Phase 3d: the telemetry plane and the fault plane on the main
    path's images (spans timed on the card, the live roofline, no
    synchronisation added by counters, recovery, overhead); returns the
    launches of each kernel it drove."""
    print("== phase 3d: telemetry, the fault plane and resilient dispatch",
          flush=True)
    import os
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import telemetry as T
    from repro_torch.faults import degrade as DG
    from repro_torch.faults import inject as FJ
    from repro_torch.faults import plan as FP
    from repro_torch.faults.policy import RETRIES
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = kernels(TW, PW)
    launched = {name: 0 for name in counters}
    expected = {name: 0 for name in counters}
    L, wav = MAIN["levels"], MAIN["wavelet"]
    kw = dict(wavelet=wav, scheme="ns-polyconv", levels=L, backend="cuda",
              device=device)
    kwi = {k: v for k, v in kw.items() if k != "levels"}
    plans = {f: R.get_plan(shape=tuple(x.shape), fuse=f, **kw)
             for f in ("pyramid", "levels", "none")}
    check(plans["pyramid"].pyramid is not None, "pyramid plan fell back")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)

    def drive(fn, k1=0, k2=0, k3=0):
        """One driven path with every launch counter at 0 just before it
        and read just after; on the card the counts must be exactly
        ``k1``/``k2``/``k3``."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        sync()
        got = {n: k.launches for n, k in counters.items()}
        want = {"tap_window": k1, "pyramid_forward": k2,
                "pyramid_inverse": k3}
        for n in launched:
            launched[n] += got[n]
            expected[n] += want[n]
        if cuda:
            check(got == want, f"phase 3d launched {got}, expected {want}")
        return out

    def equal(a, b):
        return all(torch.equal(p, q) for p, q in zip(_flat(a), _flat(b)))

    def fresh(where):
        """Zero the telemetry plane for the next step, after checking that
        nothing degraded in the last one (a reset would hide it)."""
        no_fallbacks(f"phase 3d, {where}")
        T.reset()

    # -- 1. spans on the device, inside torch.profiler -------------------
    # (a span is a profiler range whenever a profiler session records)
    T.set_mode("spans")
    fresh("start")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def four():
        for fuse in ("pyramid", "levels"):
            pyr = R.dwt2(x, fuse=fuse, **kw)
            R.idwt2(pyr, fuse=fuse, **kwi)

    with profile(activities=acts) as prof:
        drive(four, k1=2 * L, k2=1, k3=1)
    recs = T.TRACER.records()
    clock = "cuda" if cuda else "host"
    for fuse in ("pyramid", "levels"):
        for op in ("forward", "inverse"):
            ex = [r for r in recs if r.name == f"execute.{op}"
                  and r.labels.get("fuse") == fuse]
            check(len(ex) == 1, f"{len(ex)} execute.{op} spans at {fuse}")
            kids = [r for r in recs if r.parent_id == ex[0].span_id]
            want = (["pyramid.launch"] if fuse == "pyramid"
                    else [f"level.{op}"] * L)
            check([k.name for k in kids] == want,
                  f"execute.{op} at {fuse} holds {[k.name for k in kids]}")
            check(ex[0].clock == clock and all(k.clock == clock
                                               for k in kids),
                  f"execute.{op} at {fuse}: spans not timed on {clock}")
            check(ex[0].dur_s >= max(k.dur_s for k in kids) > 0,
                  f"execute.{op} at {fuse}: shorter than its children")
    trace = out_dir / "profiler_trace.json"
    prof.export_chrome_trace(str(trace))
    doc = json.loads(trace.read_text())
    names = {e.get("name") for e in doc.get("traceEvents", [])
             if e.get("cat") == "user_annotation"}
    cats = {}
    for e in doc.get("traceEvents", []):
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    check(set(SPAN_NAMES) <= names,
          f"torch.profiler trace lacks spans {set(SPAN_NAMES) - names} "
          f"(events by category: {cats})")
    if cuda:
        inside = _profiled_kernels_inside(doc, SPAN_NAMES)
        print(f"profiler: kernels by the span they were launched in: "
              f"{ {k: sorted(set(map(str, v))) for k, v in inside.items()} }")
        check(len(inside.get("pyramid_forward", [])) == 1
              and len(inside.get("pyramid_inverse", [])) == 1
              and len(inside.get("tap_window", [])) == 2 * L,
              f"profiler saw kernels {inside}")
        check(set(inside["pyramid_forward"] + inside["pyramid_inverse"])
              == {"pyramid.launch"},
              f"K2/K3 launched outside pyramid.launch: {inside}")
        check(set(inside["tap_window"]) <= {"level.forward",
                                            "level.inverse"},
              f"K1 launched outside level.*: {inside['tap_window']}")
    spans_json = T.write_chrome_trace(out_dir / "spans_trace.json")
    doc = json.loads(Path(spans_json).read_text())
    check(any(e["ph"] == "X" for e in doc["traceEvents"]),
          "span Chrome trace has no events")
    print(f"Chrome traces: {trace.relative_to(ROOT)} (torch.profiler), "
          f"{Path(spans_json).relative_to(ROOT)} (spans), both valid JSON")
    print("span,count,clock,total_ms,mean_ms,max_ms")
    for row in T.span_summary():
        print(f"{row['name']},{row['count']},{row['clock']},"
              f"{row['total_s'] * 1e3:.4f},{row['mean_s'] * 1e3:.4f},"
              f"{row['max_s'] * 1e3:.4f}")

    # -- 2. the live roofline against CUDA events -------------------------
    # the reps run back to back, as a caller's would: nothing waits for
    # the card until the roofline (the newest execution) and the ring (the
    # median over the reps) are read after them.  They are held against
    # CUDA events around the same call made back to back too; events
    # around one call on an idle card (idle_ms) also hold the host's
    # enqueue, and are printed beside them
    print("roofline: fuse,op,span_ms,gbps,ring_median_gbps,event_ms,"
          "event_gbps,ratio,idle_ms")
    fresh("spans")
    reps = 5
    for fuse in ("pyramid", "levels"):
        plan = plans[fuse]
        pyr = plan.execute(x)
        k = (0, 1, 0) if fuse == "pyramid" else (L, 0, 0)
        for op, run in (("forward", lambda: plan.execute(x)),
                        ("inverse", lambda: plan.execute_inverse(pyr))):
            T.set_mode("spans")
            T.TRACER.clear()
            drive(lambda: [run() for _ in range(reps)], k1=reps * k[0],
                  k2=reps * k[1] if op == "forward" else 0,
                  k3=reps * k[1] if op == "inverse" else 0)
            (row,) = [r for r in T.roofline()
                      if r["fuse"] == fuse and r["op"] == op]
            ring = [r.dur_s for r in T.TRACER.records()
                    if r.name == f"execute.{op}"]
            check(len(ring) == reps, f"{len(ring)} execute.{op} spans")
            bytes_ = plan.executor.hbm_bytes(op)
            ring_gbps = bytes_ / statistics.median(ring) / 1e9
            T.set_mode("counters")
            ev_ms = timer.back_to_back_ms(run, reps=20)
            idle_ms = timer.ms(run, reps=20)
            ev_gbps = bytes_ / (ev_ms / 1e3) / 1e9
            print(f"{fuse},{op},{row['seconds'] * 1e3:.4f},"
                  f"{row['gbps']:.5g},{ring_gbps:.5g},{ev_ms:.4f},"
                  f"{ev_gbps:.5g},{row['gbps'] / ev_gbps:.4f},"
                  f"{idle_ms:.4f}")
            if cuda:
                check(max(row["gbps"], ring_gbps) <= HBM_BYTES_PER_S / 1e9,
                      f"{fuse}/{op}: live roofline {row['gbps']:.1f} GB/s "
                      f"above the card's {HBM_BYTES_PER_S / 1e9:.0f}")
                check(0.5 <= row["gbps"] / ev_gbps <= 2.0
                      and 0.5 <= ring_gbps / ev_gbps <= 2.0,
                      f"{fuse}/{op}: live roofline {row['gbps']:.1f} GB/s "
                      f"(ring median {ring_gbps:.1f}) vs CUDA events "
                      f"{ev_gbps:.1f} GB/s")
    fresh("roofline")

    # -- 3. counters (and spans) mode adds no synchronisation ------------
    def both():
        for fuse in ("pyramid", "none"):
            pyr = R.dwt2(x, fuse=fuse, **kw)
            R.idwt2(pyr, fuse=fuse, **kwi)

    if cuda:
        # the counter sees a synchronising call where there is one
        control = T.synchronising_calls(lambda: float(x[0, 0, 0]))
        check(len(control) >= 1, "sync debug mode saw no synchronisation "
                                 "in a device-to-host read")
        counts, seen = {}, set()
        for mode in ("off", "counters", "spans", "spans", "counters",
                     "off"):
            T.set_mode(mode)
            calls = drive(lambda: T.synchronising_calls(both), k1=4 * L,
                          k2=1, k3=1)
            counts.setdefault(mode, []).append(len(calls))
            seen.update(calls)
        print(f"synchronising calls of dwt2+idwt2 at pyramid and none, per "
              f"mode: {counts} {sorted(seen)}")
        check(counts["counters"] == counts["off"],
              f"counters mode adds synchronisation: {counts}")
        check(counts["spans"] == counts["off"],
              f"spans mode waits for the card: {counts}")
    T.set_mode("counters")
    fresh("synchronisation")

    # -- 4. recovery on the card ------------------------------------------
    direct = drive(lambda: R.dwt2(x, fuse="levels", **kw), k1=L)
    FJ.activate(FP.FaultPlan.from_text("pyramid.launch=raise:always"))
    try:
        got = drive(lambda: R.dwt2(x, fuse="pyramid", **kw), k1=L)
    finally:
        FJ.activate(None)
    hop = DG.FALLBACKS.value(**{"from": "cuda/pyramid", "to": "cuda/levels",
                                "site": "pyramid.launch"})
    check(equal(got, direct) and hop == 1,
          f"pyramid.launch=raise:always: equal to cuda/levels "
          f"{equal(got, direct)}, fallbacks {DG.FALLBACKS.series()}")
    print("pyramid.launch=raise:always: degraded to cuda/levels (verified "
          "against torch/none), equal to a direct cuda/levels call bit for "
          "bit; K1 +%d, K2 +0; repro_fallbacks_total{from=cuda/pyramid,"
          "to=cuda/levels,site=pyramid.launch} = %d" % (L, hop))
    clean = drive(lambda: R.dwt2(x, fuse="pyramid", **kw), k2=1)
    r0 = RETRIES.value(site="execute.forward")
    FJ.activate(FP.FaultPlan.from_text("execute.forward=corrupt:once"))
    try:
        got = drive(lambda: R.dwt2(x, fuse="pyramid", **kw), k2=2)
    finally:
        FJ.activate(None)
    retries = RETRIES.value(site="execute.forward") - r0
    check(equal(got, clean) and retries == 1,
          f"execute.forward=corrupt:once: equal {equal(got, clean)}, "
          f"retries {retries}")
    print(f"execute.forward=corrupt:once: retried ({retries:.0f}), clean "
          f"result bit for bit")
    rec = drive(lambda: R.idwt2(clean, fuse="pyramid", **kwi), k3=1)
    FJ.activate(FP.FaultPlan.from_text("execute.inverse=hang:once:0.05"))
    try:
        got = drive(lambda: R.idwt2(clean, fuse="pyramid", **kwi), k3=1)
    finally:
        FJ.activate(None)
    check(torch.equal(got, rec), "execute.inverse=hang:once:0.05 changed "
                                 "the result")
    print("execute.inverse=hang:once:0.05: retried after 0.05 s, equal")
    FJ.activate(FP.FaultPlan.from_text("execute.forward=raise:always"))
    try:
        R.dwt2(x, fuse="none", **dict(kw, backend="torch"))
        exhausted = None
    except DG.DegradationExhausted as e:
        exhausted = e
    finally:
        FJ.activate(None)
    check(exhausted is not None
          and isinstance(exhausted.__cause__, FJ.InjectedFault),
          f"torch/none under raise:always: {exhausted!r}")
    print(f"torch/none under execute.forward=raise:always: "
          f"DegradationExhausted, cause {exhausted.__cause__!r}")
    os.environ[DG.ENABLE_ENV] = "off"
    DG.reload()
    FJ.activate(FP.FaultPlan.from_text("execute.forward=raise:always"))
    try:
        drive(lambda: R.dwt2(x, fuse="pyramid", **kw))
        failed_fast = False
    except FJ.InjectedFault:
        failed_fast = True
    finally:
        FJ.activate(None)
        del os.environ[DG.ENABLE_ENV]
        DG.reload()
    check(failed_fast and DG.CONFIG.enabled,
          "REPRO_TORCH_RESILIENCE=off did not fail fast")
    print(f"{DG.ENABLE_ENV}=off: the injected fault propagates (fail-fast)")
    # the one hop above is this phase's own
    check(fallbacks() == 1, f"recovery took {fallbacks()} hops, not 1: "
                            f"{DG.FALLBACKS.series()}")
    T.reset()

    # -- 5. overhead ------------------------------------------------------
    print("overhead (device): fuse,launches,timing,off_ms,counters_ms,"
          "spans_ms (dwt2, CUDA events, median of 21, around one call on an "
          "idle card or around each of 21 back-to-back calls; two passes, "
          "the second in reverse order)")
    for fuse in ("none", "pyramid"):
        rows = {"idle": {}, "back_to_back": {}}
        for mode in ("off", "counters", "spans", "spans", "counters",
                     "off"):
            T.set_mode(mode)
            for timing, ms in (("idle", timer.ms),
                               ("back_to_back", timer.back_to_back_ms)):
                rows[timing].setdefault(mode, []).append(
                    ms(lambda: R.dwt2(x, fuse=fuse, **kw), reps=21))
        for timing, row in rows.items():
            print(f"{fuse},{plans[fuse].launches},{timing},"
                  + ",".join("/".join(f"{v:.4f}" for v in row[m])
                             for m in ("off", "counters", "spans")))
    host_overhead(torch, [{"src": str(ROOT / "src"),
                           "modes": ("off", "counters", "spans"),
                           "mods": _package_modules()}], device, gen)
    fresh("overhead")
    if cuda:
        check(launched == expected,
              f"phase 3d launched {launched}, expected {expected}")
    print(f"phase 3d launches (driven paths): {launched}")
    return launched


def _planes_np_equal(torch, device, got, want):
    """Max |diff| between a host (numpy) pyramid and a device one, plane
    by plane (shapes must agree); the CROSS_TOL check is the caller's."""
    import numpy as np
    worst, ok = 0.0, True
    for g, w in zip(_flat(got), _flat(want), strict=True):
        check(tuple(g.shape) == tuple(w.shape),
              f"plane shapes {tuple(g.shape)} vs {tuple(w.shape)}")
        g = torch.from_numpy(np.ascontiguousarray(g)).to(device)
        worst = max(worst, max_abs(g, w))
        ok = ok and rel_violation(g, w, **CROSS_TOL["float32"]) <= 0
    return worst, ok


def phase_tiling(torch, R, TW, PW, device, cpu, gen, x, timer):
    """Phase 3e: tiled transforms at the main path's width, the
    out-of-core stream of a 1 GiB memmapped image, the band checkpoint
    and the stream's faults on the card, and the tiled times; returns
    the launches of each kernel it drove."""
    print("== phase 3e: tiling and out-of-core streaming", flush=True)
    import gc
    import shutil
    import numpy as np
    from repro_torch import telemetry as T
    from repro_torch.faults import inject as FJ
    from repro_torch.faults import plan as FP
    from repro_torch.faults.policy import RETRIES
    from repro_torch.tiling import open_checkpoint
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = kernels(TW, PW)
    launched = {name: 0 for name in counters}
    L, wav = MAIN["levels"], MAIN["wavelet"]
    tiles = (32, 32) if cpu else TILED["tiles"]
    over = (24, 24) if cpu else TILED["overhang"]
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    T.set_mode("counters")

    def drive(fn, k1=0, k2=0, k3=0, exact=True):
        """One driven path with every launch counter at 0 just before it
        and read just after; on the card the counts must be exactly
        ``k1``/``k2``/``k3`` (unless a retry makes them vary)."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        sync()
        got = {n: k.launches for n, k in counters.items()}
        want = {"tap_window": k1, "pyramid_forward": k2,
                "pyramid_inverse": k3}
        for n in launched:
            launched[n] += got[n]
        if cuda and exact:
            check(got == want, f"phase 3e launched {got}, expected {want}")
        return out

    def held(name, got, want):
        """Max |diff| of two pyramids (or images); bit for bit expected,
        CROSS_TOL held."""
        got = _flat(got) if hasattr(got, "ll") else [got]
        want = _flat(want) if hasattr(want, "ll") else [want]
        check([tuple(a.shape) for a in got] == [tuple(b.shape) for b in want]
              and all(bool(torch.isfinite(a).all()) for a in got),
              f"{name}: shapes or finiteness")
        d = max(max_abs(a, b) for a, b in zip(got, want))
        check(all(rel_violation(a, b, **CROSS_TOL["float32"]) <= 0
                  for a, b in zip(got, want)),
              f"{name}: off by {d}")
        return d

    # -- 1. tiled at the main path's width --------------------------------
    kw = dict(wavelet=wav, levels=L, scheme="ns-polyconv", backend="cuda",
              device=device)
    ikw = {k: v for k, v in kw.items() if k != "levels"}
    plans = {}
    for fuse, (k1, kp) in TILED_LAUNCHES.items():
        plan = R.get_plan(shape=tuple(x.shape), fuse=fuse, tiles=tiles, **kw)
        plans[fuse] = plan
        g = plan.grid
        if not cpu:
            check(g.grid_shape == (4, 4) and g.margin == TILED["margin"]
                  and g.window_shape == (576, 576),
                  f"tiled {fuse}: grid {g.describe()}")
        check(plan.launches == k1 + kp and plan.pyramid is None,
              f"tiled {fuse}: plan.launches {plan.launches}")
        mono = R.dwt2(x, fuse=fuse, **kw)
        tiled = drive(lambda: R.dwt2(x, fuse=fuse, tiles=tiles, **kw),
                      k1=k1, k2=kp)
        d_fwd = held(f"tiled {fuse} dwt2 vs monolithic", tiled, mono)
        rec_mono = R.idwt2(mono, fuse=fuse, **ikw)
        rec = drive(lambda: R.idwt2(mono, fuse=fuse, tiles=tiles, **ikw),
                    k1=k1, k3=kp)
        d_inv = held(f"tiled {fuse} idwt2 vs monolithic", rec, rec_mono)
        rec_t = drive(lambda: R.idwt2(tiled, fuse=fuse, tiles=tiles, **ikw),
                      k1=k1, k3=kp)
        rt = max_abs(rec_t, x)
        check(rel_violation(rec_t, x, **ROUNDTRIP_TOL["float32"]) <= 0,
              f"tiled {fuse}: round trip off by {rt}")
        before = R.plan_cache_stats()
        drive(lambda: R.dwt2(x, fuse=fuse, tiles=tiles, **kw), k1=k1, k2=kp)
        after = R.plan_cache_stats()
        check(after["hits"] == before["hits"] + 2
              and after["misses"] == before["misses"],
              f"tiled {fuse}: second call's cache traffic {before} -> "
              f"{after} (the tiled plan and its window plan must both hit)")
        print(f"tiled {fuse:7s} {g.describe()}: launches fwd/inv "
              f"{k1 + kp}/{k1 + kp} (K1 {k1}, K2/K3 {kp}); vs monolithic "
              f"max |diff| forward {d_fwd!r} inverse {d_inv!r}"
              f"{' (bit for bit)' if d_fwd == d_inv == 0 else ''}; round "
              f"trip {rt!r}; second call: 2 cache hits, 0 misses")
        del mono, tiled, rec_mono, rec, rec_t
    okw = dict(kw, scheme="sep-lifting", wavelet="dd137")
    oikw = {k: v for k, v in okw.items() if k != "levels"}
    plan = R.get_plan(shape=tuple(x.shape), fuse="levels", tiles=over, **okw)
    g = plan.grid
    check(g.grid_shape[0] * g.tile[0] > x.shape[-2],
          f"overhang tiling {g.describe()} does not overhang")
    mono = R.dwt2(x, fuse="levels", **okw)
    tiled = drive(lambda: R.dwt2(x, fuse="levels", tiles=over, **okw), k1=L)
    d_fwd = held("overhang dwt2 vs monolithic", tiled, mono)
    rec = drive(lambda: R.idwt2(mono, fuse="levels", tiles=over, **oikw),
                k1=L)
    d_inv = held("overhang idwt2 vs monolithic", rec,
                 R.idwt2(mono, fuse="levels", **oikw))
    print(f"overhang sep-lifting dd137 levels {g.describe()}: vs "
          f"monolithic max |diff| forward {d_fwd!r} inverse {d_inv!r}")
    del mono, tiled, rec

    # -- 2. the out-of-core stream of a memmapped image --------------------
    n = 256 if cpu else STREAM["size"]
    st_tiles = (64, 64) if cpu else STREAM["tiles"]
    path = out_dir / "stream_image.f32"
    rng = np.random.default_rng(0)
    disk = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, n))
    for r0 in range(0, n, 1024):
        rows = min(1024, n - r0)
        disk[r0:r0 + rows] = rng.standard_normal((rows, n),
                                                 dtype=np.float32)
    disk.flush()
    del disk
    img = np.memmap(path, dtype=np.float32, mode="r", shape=(n, n))
    skw = dict(wavelet=wav, levels=L, scheme="ns-polyconv", tiles=st_tiles,
               fuse="levels", max_inflight=STREAM["max_inflight"],
               device=device)
    splan = R.get_plan(shape=(n, n), tiles=st_tiles, fuse="levels",
                       wavelet=wav, levels=L, scheme="ns-polyconv",
                       device=device)
    nr, nc = splan.grid.grid_shape
    wh, ww = splan.grid.window_shape
    band_bytes = nc * wh * ww * 4
    k_band = splan.launches
    box = {}
    if cuda:
        # tensors earlier phases left in reference cycles (an exception
        # kept with its traceback holds its frame's locals) are freed
        # first, so that the peak below is the stream's and the main
        # path's images'
        gc.collect()
        before_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls = drive(lambda: T.synchronising_calls(
            lambda: box.setdefault("pyr", R.stream_dwt2(img, **skw))),
            k1=nr * k_band)
        peak = torch.cuda.max_memory_allocated()
        check(peak < img.nbytes,
              f"stream peak device memory {peak} B ({before_bytes} B "
              f"allocated before it) is not below the image's "
              f"{img.nbytes} B")
        check(len(calls) <= nr, f"stream synchronised {len(calls)} times "
                                f"for {nr} bands: {calls}")
        print(f"stream {n}x{n} fp32 ({img.nbytes} B memmap), tiles "
              f"{st_tiles}: {nr} bands of {nc} windows {wh}x{ww} "
              f"({band_bytes} B per band); peak device memory {peak} B "
              f"({before_bytes} B allocated before it); synchronising calls "
              f"{len(calls)} {sorted(set(calls))}")
    else:
        box["pyr"] = drive(lambda: R.stream_dwt2(img, **skw),
                           k1=nr * k_band)
    slots = splan._stream_slots
    check(len(slots) == STREAM["max_inflight"] + 1,
          f"{len(slots)} staging slots")
    if cuda:
        check(all(s.stage.is_pinned() and all(o.is_pinned() for o in s.out)
                  for s in slots), "a staging buffer is not pinned")
        print(f"staging: {len(slots)} slots, every buffer pinned")
    T.set_mode("spans")
    T.reset()
    t0 = time.perf_counter()
    drive(lambda: R.stream_dwt2(img, **skw), k1=nr * k_band)
    wall = time.perf_counter() - t0
    rows = {r["name"]: r for r in T.span_summary()}
    T.set_mode("counters")
    print(f"stream wall {wall:.4f} s (spans mode); span totals s: " + ", ".join(
        f"{nm} {rows[nm]['total_s']:.4f} ({rows[nm]['count']})"
        for nm in ("stream.dwt2", "stream.host_gather",
                   "stream.h2d_dispatch", "stream.drain") if nm in rows))
    T.reset()
    mono = R.dwt2(torch.from_numpy(np.array(img)), fuse="levels", wavelet=wav,
                  levels=L, scheme="ns-polyconv", device=device)
    d, ok = _planes_np_equal(torch, device, box.pop("pyr"), mono)
    check(ok, f"stream vs monolithic off by {d}")
    print(f"stream vs monolithic dwt2 ({n}x{n}, fuse levels): max |diff| "
          f"{d!r}{' (bit for bit)' if d == 0 else ''}")
    del mono, img

    # -- 3. checkpoint and the stream's faults on the card ----------------
    m = 128 if cpu else CHECKPOINT["size"]
    ck_tiles = (32, 32) if cpu else CHECKPOINT["tiles"]
    ck_img = rng.standard_normal((m, m), dtype=np.float32)
    ckw = dict(skw, tiles=ck_tiles)
    nb = -(-m // ck_tiles[0])
    ref = drive(lambda: R.stream_dwt2(ck_img, **ckw), k1=nb * k_band)
    ck = out_dir / "checkpoint"
    shutil.rmtree(ck, ignore_errors=True)
    drive(lambda: R.stream_dwt2(ck_img, checkpoint=str(ck), **ckw),
          k1=nb * k_band)
    jp = ck / "journal.jsonl"
    lines = jp.read_text().splitlines()
    check(len(lines) == nb, f"journal has {len(lines)} records")
    jp.write_text("\n".join(lines[:2]) + "\n")
    man = json.loads((ck / "manifest.json").read_text())["config"]
    ck2 = open_checkpoint(str(ck), man)
    check(ck2.completed == {0, 1}, f"resumable bands {ck2.completed}")
    cut = 2 * (ck_tiles[0] >> L)
    ck2.ll[cut:] = -777.0
    for plane in ck2.details[-1]:
        plane[2 * (ck_tiles[0] >> 1):] = -777.0
        plane.flush()
    ck2.ll.flush()
    resumed = drive(lambda: R.stream_dwt2(ck_img, checkpoint=str(ck), **ckw),
                    k1=(nb - 2) * k_band)
    check(all(np.array_equal(a, b) for a, b in zip(_flat(resumed),
                                                   _flat(ref))),
          "resumed stream differs from the uninterrupted one")
    print(f"checkpoint {m}x{m}, {nb} bands: killed after 2, rows poisoned, "
          f"resumed ({nb - 2} bands recomputed) equal bit for bit")
    del resumed, ck2
    r0 = sum(row["value"] for row in RETRIES.series())
    FJ.activate(FP.FaultPlan.from_text(
        "stream.host_gather=0.3,stream.drain=0.3", seed=STREAM["fault_seed"]))
    try:
        got = drive(lambda: R.stream_dwt2(ck_img, retries=4, **ckw),
                    exact=False)
        fired = FJ.stats()["plan"]["sites"]
    finally:
        FJ.activate(None)
    retried = sum(row["value"] for row in RETRIES.series()) - r0
    check(all(np.array_equal(a, b) for a, b in zip(_flat(got), _flat(ref)))
          and retried > 0,
          f"retried stream: {retried} retries, result differs")
    print(f"stream.host_gather / stream.drain at 0.3 (seed "
          f"{STREAM['fault_seed']}): fired "
          f"{fired['stream.host_gather']['fired']} / "
          f"{fired['stream.drain']['fired']}, {retried} retries, equal bit "
          f"for bit")
    FJ.activate(FP.FaultPlan.from_text("stream.h2d_dispatch=once"))
    try:
        drive(lambda: R.stream_dwt2(ck_img, retries=0, **ckw))
        raised = None
    except FJ.InjectedFault as e:
        raised = repr(e)        # not the exception: its frames hold tensors
    finally:
        FJ.activate(None)
    check(raised is not None, "stream.h2d_dispatch=once with retries=0 "
                              "did not raise InjectedFault")
    print(f"stream.h2d_dispatch=once, retries=0: raised {raised}")
    clean = R.dwt2(x, fuse="pyramid", tiles=tiles, **kw)
    r0 = sum(row["value"] for row in RETRIES.series())
    FJ.activate(FP.FaultPlan.from_text("tiling.halo_gather=raise:once"))
    try:
        got = drive(lambda: R.dwt2(x, fuse="pyramid", tiles=tiles, **kw),
                    k2=1)
    finally:
        FJ.activate(None)
    retried = sum(row["value"] for row in RETRIES.series()) - r0
    check(retried == 1 and all(torch.equal(a, b) for a, b in
                               zip(_flat(got), _flat(clean))),
          f"tiling.halo_gather=raise:once: {retried} retries")
    print("tiling.halo_gather=raise:once on tiled pyramid dwt2: retried "
          "once, equal to a clean call bit for bit")
    del clean, got, ref
    no_fallbacks("phase 3e")

    # -- 4. times: tiled vs monolithic, and the tiled spans ----------------
    reps = TIMING_REPS
    print(f"tiled times (ms; CUDA events around each of {reps} calls made "
          f"back to back, median; spans: device-timed tile.* spans, mean "
          f"over the same number of calls)")
    print("fuse,op,tiled_ms,monolithic_ms,ratio,halo_gather_ms,"
          "window_transform_ms,stitch_ms,tiled_model_bytes,"
          "monolithic_model_bytes,tiled_bound_ms")
    for fuse, plan in plans.items():
        mplan = R.get_plan(shape=tuple(x.shape), fuse=fuse, **kw)
        pyr = R.dwt2(x, fuse=fuse, **kw)
        runs = {
            "forward": (lambda: R.dwt2(x, fuse=fuse, tiles=tiles, **kw),
                        lambda: R.dwt2(x, fuse=fuse, **kw)),
            "inverse": (lambda: R.idwt2(pyr, fuse=fuse, tiles=tiles, **ikw),
                        lambda: R.idwt2(pyr, fuse=fuse, **ikw))}
        for op, (tiled_fn, mono_fn) in runs.items():
            for k in counters.values():
                k.launches = 0
            t_ms = timer.back_to_back_ms(tiled_fn, reps=reps)
            m_ms = timer.back_to_back_ms(mono_fn, reps=reps)
            T.set_mode("spans")
            T.reset()
            for _ in range(reps):
                tiled_fn()
            sync()
            spans = {}
            for r in T.TRACER.records():
                if r.name.startswith("tile.") and r.labels.get("op") == op:
                    spans.setdefault(r.name, []).append(r.dur_s * 1e3)
            T.set_mode("counters")
            T.reset()
            for k in counters.values():
                k.launches = 0      # timing launches are not the path's
            mean = {nm: statistics.mean(v) for nm, v in spans.items()}
            tb = plan.executor.hbm_bytes(op)
            mb = mplan.executor.hbm_bytes(op)
            print(f"{fuse},{op},{t_ms:.4f},{m_ms:.4f},{t_ms / m_ms:.4f},"
                  f"{mean.get('tile.halo_gather', float('nan')):.4f},"
                  f"{mean.get('tile.window_transform', float('nan')):.4f},"
                  f"{mean.get('tile.stitch', float('nan')):.4f},{tb},{mb},"
                  f"{tb / HBM_BYTES_PER_S * 1e3:.4f}")
        del pyr
    no_fallbacks("phase 3e times")
    print(f"phase 3e launches (driven paths): {launched}")
    return launched


# phase 3f: the profiler, backend="auto" and serving at the main path's
# width (B=8 buckets of 2048^2 fp32 images, 3 levels, cdf97, ns-polyconv)
SERVE = dict(max_batch=8, requests=32, burst=16, unseen=(8, 1024, 1024),
             block_targets=((32, 64), (32, 32), (16, 64)), reps=5)


def phase_serving(torch, R, TW, PW, device, cpu, gen):
    """Phase 3f: the profiler store warmed over every candidate and
    padded batch size, "auto" resolved cold, from the store and from the
    model, a block-table sweep, and a DwtServer on the card answering
    forward and inverse requests bit for bit against direct calls, with
    one pinned h2d copy per forward batch and a worker killed mid-burst;
    returns the launches of each kernel it drove."""
    print("== phase 3f: the profiler, backend=\"auto\" and serving",
          flush=True)
    import asyncio
    import os
    import shutil
    import numpy as np
    from repro_torch import engine as E
    from repro_torch import profiler as PF
    from repro_torch import telemetry as T
    from repro_torch.engine import autotune as AT
    from repro_torch.profiler import auto as PA
    from repro_torch.serve import (BucketSpec, DwtServer, ServeConfig,
                                   bucket_batches, serve_stats)
    from repro_torch.serve import metrics as SM
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = kernels(TW, PW)
    launched = {name: 0 for name in counters}
    L, wav, scheme = MAIN["levels"], MAIN["wavelet"], "ns-polyconv"
    size = 64 if cpu else MAIN["size"]
    max_batch = 2 if cpu else SERVE["max_batch"]
    reps = 1 if cpu else SERVE["reps"]
    unseen = (2, 32, 32) if cpu else SERVE["unseen"]
    n_req = 4 if cpu else SERVE["requests"]
    work = ROOT / "build" / "chip_smoke" / "phase3f"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = {"REPRO_TORCH_PROFILE_STORE": str(work / "store.jsonl"),
           "REPRO_TORCH_BLOCK_TABLE": str(work / "table.json")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    AT.clear_cache()
    E.clear_plan_cache()
    T.set_mode("counters")
    PA.reset_counters()
    SM.reset()
    card = "cpu rehearsal" if cpu else nvidia_smi()
    dev = str(E.resolve_device(device))

    def drive(fn):
        """One driven step with every launch counter at 0 just before it
        and read just after; returns (its result, its launches)."""
        for k in counters.values():
            k.launches = 0
        out = fn()
        sync()
        got = {n: k.launches for n, k in counters.items()}
        for n in launched:
            launched[n] += got[n]
        return out, got

    def key_of(shape):
        return E.canonical_key(E.PlanKey(
            wavelet=wav, scheme=scheme, levels=L, shape=tuple(shape),
            dtype="float32", backend="auto", optimize=False, fuse="none",
            boundary="periodic", device=dev))

    try:
        # 1. cold start: an empty store resolves by the device's rule
        cold = PF.choose(key_of((max_batch, size, size)))
        want = ("torch", "levels") if cpu else ("cuda", "pyramid")
        print(f"cold: {cold.backend}/{cold.fuse} source={cold.source}")
        check((cold.backend, cold.fuse) == want
              and cold.source == "heuristic",
              f"cold auto resolved {cold}, expected {want} from the rule")

        # 2. warm the store: every candidate at every padded batch size
        batches = bucket_batches(max_batch)
        recs, got = drive(lambda: PF.warm_batches(
            batches, (size, size), wavelet=wav, scheme=scheme, levels=L,
            reps=reps, device=dev))
        n_cand = len(PF.enumerate_candidates(key_of((1, size, size))))
        check(len(recs) == n_cand * len(batches),
              f"warm_batches wrote {len(recs)} records, expected "
              f"{n_cand} x {len(batches)}")
        print(f"store: {len(recs)} records ({n_cand} candidates x batches "
              f"{batches}, median of {reps} back-to-back calls each, "
              f"wall time per call), launches {got}; {card}")
        print("batch,backend,fuse,time_ms,spread,launches,model_bytes")
        for r in recs:
            print(f"{r.shape[0]},{r.backend},{r.fuse},{r.time_s * 1e3:.4f},"
                  f"{r.meta['spread']:.3f},{r.launches},{r.hbm_bytes}")

        # 3. every batch size now resolves from the store, at the argmin
        choices = {}
        for b in batches:
            c = PF.choose(key_of((b, size, size)))
            best = min((r for r in recs if r.shape[0] == b),
                       key=lambda r: (r.time_s, r.backend, r.fuse))
            choices[b] = c
            print(f"auto b={b}: {c.backend}/{c.fuse} source={c.source} "
                  f"{c.predicted_s * 1e3:.4f} ms")
            check(c.source == "store" and (c.backend, c.fuse) ==
                  (best.backend, best.fuse),
                  f"b={b} resolved {c}, store argmin {best.backend}/"
                  f"{best.fuse}")

        # 4. an unseen shape: the model predicts, a measurement compares
        plan = E.get_plan(wavelet=wav, scheme=scheme, levels=L,
                          shape=unseen, backend="auto", device=dev)
        check(plan.auto.source == "model",
              f"unseen {unseen} resolved from {plan.auto.source}")
        rec, got = drive(lambda: PF.profile_plan(plan, reps=reps,
                                                 record=False))
        (row,) = [r for r in T.roofline() if r["op"] == "profile"
                  and r["backend"] == plan.key.backend
                  and r["fuse"] == plan.key.fuse]
        print(f"model: {unseen} -> {plan.key.backend}/{plan.key.fuse}, "
              f"predicted {plan.auto.predicted_s * 1e3:.4f} ms, measured "
              f"{rec.time_s * 1e3:.4f} ms (spread {rec.meta['spread']:.3f}),"
              f" repro_model_time_ratio {row['model_time_ratio']:.4f}, "
              f"launches {got}")

        # 6. serve: a bucket resolved from the warmed store
        resolved = {b: E.get_plan(**BucketSpec(
            shape=(size, size), levels=L, backend="auto").key(
                "dwt2", dev).plan_kwargs(b)).key for b in batches}
        configs = {(k.backend, k.fuse, k.tap_opt) for k in resolved.values()}
        rng = np.random.default_rng(18)
        imgs = [rng.standard_normal((size, size)).astype(np.float32)
                for _ in range(n_req)]
        cfg = ServeConfig(max_batch=max_batch, num_workers=2, device=dev)
        srv = DwtServer(cfg)
        srv.warmup([BucketSpec(shape=(size, size), levels=L,
                               backend="auto")], warm_profiler=False)
        SM.reset()
        misses0 = E.plan_cache_stats()["misses"]

        async def serve_all():
            async with srv:
                fwd = await asyncio.gather(*[srv.submit(
                    im, levels=L, backend="auto") for im in imgs])
                inv = await asyncio.gather(*[srv.submit_inverse(
                    p, backend="auto") for p in fwd])
                return fwd, inv
        t0 = time.perf_counter()
        (fwd, inv), got = drive(lambda: asyncio.run(
            asyncio.wait_for(serve_all(), 300)))
        wall = time.perf_counter() - t0
        st = serve_stats()
        misses = E.plan_cache_stats()["misses"] - misses0
        check(misses == 0, f"{misses} plan-cache misses after warmup")
        no_fallbacks("phase 3f, serve")
        check(st["served"] == 2 * n_req and st["failed"] == 0,
              f"served {st}")
        def served_ok(im, pyr):
            """The served pyramid equals a direct dwt2 of its one image at
            a configuration "auto" resolved for the bucket: bit for bit,
            or within CROSS_TOL on "conv" (F.conv2d picks its algorithm
            per batch size)."""
            served = [torch.from_numpy(a) for a in _flat(pyr)]
            for backend, fuse, tap_opt in sorted(configs):
                want = [a.cpu() for a in _flat(R.dwt2(
                    torch.from_numpy(im).to(device), wavelet=wav, levels=L,
                    scheme=scheme, backend=backend, fuse=fuse,
                    tap_opt=tap_opt, device=device))]
                if all(torch.equal(a, b) for a, b in zip(want, served)) or (
                        backend == "conv" and all(
                            rel_violation(b, a, **CROSS_TOL["float32"]) <= 0
                            for a, b in zip(want, served))):
                    return True
            return False

        diff = 0.0
        for im, pyr, back in zip(imgs, fwd, inv):
            check(served_ok(im, pyr), f"a served pyramid differs from every "
                  f"direct dwt2 at the resolved configurations "
                  f"{sorted(configs)}")
            check(bool(np.isfinite(back).all()), "inverse not finite")
            check(rel_violation(torch.from_numpy(back), torch.from_numpy(im),
                                **ROUNDTRIP_TOL["float32"]) <= 0,
                  "served inverse does not round-trip")
            diff = max(diff, float(np.abs(back - im).max()))
        print(f"serve: {2 * n_req} requests ({n_req} dwt2 + {n_req} idwt2) "
              f"in {st['batches']} batches, auto -> {sorted(configs)}; "
              f"equal to direct dwt2 (bit for bit off \"conv\"), round "
              f"trip max |diff| {diff}; "
              f"plan-cache misses after warmup {misses}; launches {got}")
        print(f"serve metrics: p50 {st['p50_ms']:.4f} ms, p99 "
              f"{st['p99_ms']:.4f} ms, {st['img_per_s']:.1f} img/s, mean "
              f"occupancy {st['mean_occupancy']:.3f}, wall {wall:.3f} s; "
              f"{card}")
        del fwd, inv

        # where a served batch's time goes: the serve.* spans (host
        # clock) and the plan's execute.* spans (device clock)
        srv_s = DwtServer(cfg)

        async def spanned():
            async with srv_s:
                return await asyncio.gather(*[srv_s.submit(
                    im, levels=L, backend="auto") for im in imgs])
        T.set_mode("spans")
        T.TRACER.clear()
        try:
            _, got = drive(lambda: asyncio.run(
                asyncio.wait_for(spanned(), 300)))
            rows = [r for r in T.span_summary()
                    if r["name"].startswith(("serve.", "execute."))]
        finally:
            T.set_mode("counters")
        print(f"serve spans ({n_req} dwt2 requests, spans mode): "
              f"name,count,clock,total_ms,mean_ms,max_ms; launches {got}")
        for r in rows:
            print(f"{r['name']},{r['count']},{r['clock']},"
                  f"{r['total_s'] * 1e3:.4f},{r['mean_s'] * 1e3:.4f},"
                  f"{r['max_s'] * 1e3:.4f}")

        # 7. a worker dies during a burst: every request still served
        burst = imgs[:(4 if cpu else SERVE["burst"])]
        srv_d = DwtServer(cfg)
        SM.reset()

        async def killed():
            async with srv_d:
                victim = srv_d.inject_worker_failure()
                out = await asyncio.gather(*[srv_d.submit(
                    im, levels=L, backend="auto") for im in burst])
                return out, victim, srv_d.stats()
        (out, victim, ws), got = drive(lambda: asyncio.run(
            asyncio.wait_for(killed(), 300)))
        st = serve_stats()
        for im, pyr in zip(burst, out):
            check(served_ok(im, pyr),
                  "a request served after the worker's death differs")
        check(st["served"] == len(burst) and st["worker_deaths"] == 1
              and st["workers_spawned"] == 1 and victim in
              ws["workers"]["dead"],
              f"worker death: {st}, workers {ws['workers']}")
        print(f"worker death: {victim} killed mid-burst, {st['served']} of "
              f"{len(burst)} served as direct calls, {st['redispatched']} "
              f"re-dispatched, {st['workers_spawned']} replacement; "
              f"launches {got}")
        no_fallbacks("phase 3f, worker death")

        # 5. the block table: sweep targets for the "levels" plan, save
        # the fastest, rebuild through the table
        lkey = E.canonical_key(E.PlanKey(
            wavelet=wav, scheme=scheme, levels=L,
            shape=(max_batch, size, size), dtype="float32", backend="cuda",
            optimize=False, fuse="levels", boundary="periodic", device=dev))
        x = torch.randn((max_batch, size, size), generator=gen).to(device)
        default_plan = E.build_plan(lkey)
        ref_pyr = default_plan.execute(x)
        sweep = {}
        for t in SERVE["block_targets"]:
            p = E.build_plan(lkey, block_target=t)
            ts, got = drive(lambda: PF.measure_times(p, x, reps=reps))
            sweep[t] = (statistics.median(ts), p)
            print(f"block target {t}: blocks "
                  f"{[ls.block for ls in p.level_specs]}, "
                  f"{statistics.median(ts) * 1e3:.4f} ms "
                  f"(spread {(max(ts) - min(ts)) / statistics.median(ts):.3f})"
                  f", launches {got}")
        best_t = min(sweep, key=lambda t: sweep[t][0])
        AT.save_entry(scheme, (size, size), "levels", "cuda", best_t,
                      device=dev)
        tuned = E.build_plan(lkey)
        want_blocks = [ls.block for ls in sweep[best_t][1].level_specs]
        check([ls.block for ls in tuned.level_specs] == want_blocks,
              f"rebuilt plan blocks {[ls.block for ls in tuned.level_specs]}"
              f", table target {best_t} gives {want_blocks}")
        out_pyr, got = drive(lambda: tuned.execute(x))
        same = all(torch.equal(a, b) for a, b in zip(_flat(out_pyr),
                                                     _flat(ref_pyr)))
        print(f"block table: best target {best_t} saved; rebuilt plan "
              f"blocks {want_blocks}; outputs equal the default block's "
              f"bit for bit: {same}; launches {got}")
        before = AT.COUNTERS["device_fallbacks"]
        AT.save_entry(scheme, (size, size), "none", "cuda", (8, 8),
                      fingerprint="cuda:NVIDIA Elsewhere")
        check(AT.lookup(scheme, (size, size), "none", "cuda", dev) is None
              and AT.COUNTERS["device_fallbacks"] == before + 1,
              "a foreign-fingerprint entry was applied or not counted")
        print("block table: a foreign-fingerprint entry skipped and counted")
        no_fallbacks("phase 3f, block table")

        # the h2d copies of a few forward batches, in a profiler trace of
        # a warmed server at the resolved configuration, taken in a fresh
        # process (in this one, after the earlier phases, the trace held
        # the server's d2h copies but not its h2d copies)
        if cuda:
            backend, fuse, tap_opt = sorted(configs)[-1]
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--serve-trace", backend, fuse, tap_opt, str(size),
                 str(max_batch)], capture_output=True, text=True,
                timeout=600)
            check(out.returncode == 0 and out.stdout.strip(),
                  f"--serve-trace failed: {out.stdout[-2000:]}"
                  f"{out.stderr[-2000:]}")
            tr = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"trace ({tr['trace']}, a fresh process, {backend}/{fuse}):"
                  f" {tr['batches']} forward batches, device copies "
                  f"{tr['copies']}, {tr['k2']} K2 kernels; launches "
                  f"{tr['launches']}")
            h2d = {n: c for n, c in tr["copies"].items() if "HtoD" in n}
            check(h2d == {"Memcpy HtoD (Pinned -> Device)": tr["batches"]},
                  f"h2d copies {h2d} for {tr['batches']} forward batches")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        AT.clear_cache()
        E.clear_plan_cache()
    print(f"phase 3f launches (driven paths): {launched}")
    print(f"phase 3f took {time.perf_counter() - t_phase:.1f} s")
    return launched


# phase 3g: the dense LM training path at qwen2-0.5b's full width and
# depth (SMOKE under --cpu-rehearsal), gradient compression dwt:2 (cdf97)
LM = dict(arch="qwen2-0.5b", seq=4096, batch=4, compressed=4, plain=2,
          prompt=16, restart_layers=2, restart_steps=3)
LM_REHEARSAL = dict(LM, seq=32, compressed=2, plain=1, prompt=8)
DECODE_TOL = 2e-2       # prefill/decode vs forward (tests/test_models.py:43)
RESTART_RTOL = 1e-5


@contextlib.contextmanager
def k1_calls(TW, fn):
    """Route every K1 call through ``fn(kernel, win, src, **kw)`` (the
    executor looks ``tap_window`` up on the module at each call; ``src``
    is four planes or an image, ``kw`` the output layout)."""
    kernel = TW.tap_window
    TW.tap_window = lambda win, src, **kw: fn(kernel, win, src, **kw)
    try:
        yield
    finally:
        TW.tap_window = kernel


def outputs(out):
    """A K1 call's outputs as a tuple: its four planes, or its image."""
    return (out,) if hasattr(out, "shape") else tuple(out)


def versus_plain(TW, seen):
    """A K1 shim for :func:`k1_calls`: each call's outputs compared with
    its plain version on the same input and layout, the largest |diff|
    and the calls compared counted in ``seen`` (keys "worst" and
    "calls")."""
    def shim(kernel, win, src, **kw):
        out = kernel(win, src, **kw)
        ref = TW.tap_window_ref(win, src, **kw)
        seen["worst"] = max([seen["worst"]] + [
            max_abs(a, b) for a, b in zip(outputs(out), outputs(ref))])
        seen["calls"] += 1
        return out
    return shim


def _compression_launches(E, CMP, pytree, params, levels, device):
    """K1 launches of one compressed step: forward and inverse plan of
    every leaf's tile, ``plan.launches`` each; and the tiles."""
    tiles = [CMP.tile_shape(p.numel(), levels) for p in pytree.leaves(params)]
    plans = [E.get_plan(scheme=CMP.SCHEME, levels=levels, shape=t,
                        device=device) for t in tiles]
    return sum(2 * p.launches for p in plans), tiles


STEP_KERNELS = (("K1 tap_window", ("tap_window",)),
                ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                ("softmax / logsumexp", ("softmax", "logsumexp")),
                ("reduction", ("reduce",)),
                ("copy / cast / cat / index", ("copy", "cat", "index",
                                               "gather", "scatter")),
                ("other elementwise", ("elementwise",)))


def profile_step(torch, ST, box, batch, cfg, run, cuda, sync,
                 label="phase3g"):
    """One train step inside ``torch.profiler`` (device activity only, so
    each kernel is counted once): device time by kernel, summed into
    coarse groups by name (first match in STEP_KERNELS) and the top
    kernels, printed as the JSON line ``{label}_profile``; "not measured"
    where the trace holds no device time (the CPU).  The state comes in
    ``box`` (a one-element list) as :func:`train_rows` says; returns the
    state after the step (one more step of the run)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    state = box.pop()
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = ST.train_step(state, batch, cfg, run)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((e.key, e.count, us / 1e3))
    total = sum(ms for _, _, ms in rows)
    if not total:
        print("profiled step: device time by kernel not measured "
              "(the trace holds no device time)")
        return state
    groups = {}
    for name, _, ms in rows:
        low = name.lower()
        group = next((g for g, keys in STEP_KERNELS
                      if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"profiled compressed step: {total:.1f} ms of device time in "
          f"{len(rows)} kernels (torch.profiler, self device time) over "
          f"{wall_ms:.1f} ms of wall time: the card busy "
          f"{100 * total / wall_ms:.1f}% (kernels may overlap)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:26s} {ms:9.2f} ms  {100 * ms / total:5.1f}%")
    for name, n, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"  top: {ms:9.2f} ms  x{n:<5d} {name[:100]}")
    print(json.dumps({f"{label}_profile": {
        "device_ms": total, "wall_ms": wall_ms, "groups_ms": groups,
        "top": [[name[:100], n, ms] for name, n, ms in
                sorted(rows, key=lambda r: -r[2])[:12]]}}))
    return state


class Launches:
    """The launch counters of a phase: ``zero()`` before a driven path,
    ``read(what, k1)`` after it checks K1 ran ``k1`` times (none on the
    CPU, where the wrappers run the plain versions) and K2/K3 never, and
    adds the launches to the phase's own unless they were made to
    compare K1 with its plain version."""

    def __init__(self, TW, PW, cpu, phase):
        self.counters = kernels(TW, PW)
        self.launched = {name: 0 for name in self.counters}
        self.cpu, self.phase = cpu, phase

    def zero(self):
        for k in self.counters.values():
            k.launches = 0

    def read(self, what, k1, count=True):
        got = {n: k.launches for n, k in self.counters.items()}
        want = {"tap_window": 0 if self.cpu else k1, "pyramid_forward": 0,
                "pyramid_inverse": 0}
        check(got == want, f"{self.phase} {what} launched {got}, "
                           f"expected {want}")
        if count:
            for n in self.launched:
                self.launched[n] += got[n]
        return got


def train_rows(torch, T, ST, box, pipe, shape, cfg, runs, device, sync,
               where):
    """One train step per run config in ``runs`` (batches ``pipe`` gives
    at steps 0, 1, ...) under ``spans`` telemetry: each step's loss, aux
    loss, wall ms (a synchronise around it) and its ``train.*`` and
    ``execute.*`` device spans in ms.  Every loss must be finite.

    The state comes in ``box``, a one-element list the caller holds no
    other reference beside: a step returns new trees, and a caller's
    reference to the first state would keep it alive beside every later
    step's (25.6 GiB more at mixtral's width).  Returns (the new state,
    the rows)."""
    import math
    state = box.pop()
    T.set_mode("spans")
    T.TRACER.clear()
    rows = []
    try:
        for i, r in enumerate(runs):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.batch_at(i, shape).items()}
            sync()
            t0 = time.perf_counter()
            state, m = ST.train_step(state, batch, cfg, r)
            loss, aux = float(m["loss"]), float(m["aux"])
            sync()
            wall = time.perf_counter() - t0
            spans = {}
            for rec in T.TRACER.records():
                spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_s * 1e3
            T.TRACER.clear()
            check(math.isfinite(loss), f"{where}: step {i} loss {loss}")
            rows.append(dict(step=i, compression=r.grad_compression,
                             loss=loss, aux=aux, wall_ms=wall * 1e3,
                             **spans))
    finally:
        T.set_mode("counters")
    return state, rows


DWT_SPANS = ("execute.forward", "execute.inverse")


def print_rows(rows, tokens):
    print("step  compression  loss      step_ms   grads_ms  compress_ms "
          "dwt_ms   adamw_ms  wall_ms   tokens/s")
    for row in rows:
        print(f"{row['step']:4d}  {row['compression']:11s}  "
              f"{row['loss']:.4f}  {row.get('train.step', 0):8.2f}  "
              f"{row.get('train.grads', 0):8.2f}  "
              f"{row.get('train.compress', 0):11.2f}  "
              f"{sum(row.get(k, 0) for k in DWT_SPANS):7.2f}  "
              f"{row.get('train.adamw', 0):8.2f}  {row['wall_ms']:8.2f}  "
              f"{tokens / row['wall_ms'] * 1e3:9.1f}")


def hold_k1(torch, R, TW, CMP, pytree, grads, efb, step, levels, device,
            where):
    """Compression of one step's real gradients ``grads`` (with error
    feedback ``efb``) through K1, every launch compared with its plain
    version on the same planes, and ``g_hat`` against the same transform
    pair on backend "torch".  Returns (the largest K1 |diff|, the K1
    calls compared, the worst ``CROSS_TOL`` margin)."""
    phase = int(step) % CMP.n_phases(levels)
    seen = dict(worst=0.0, calls=0)
    import math
    cross = -math.inf
    with torch.no_grad(), k1_calls(TW, versus_plain(TW, seen)):
        for g, e in zip(pytree.leaves(grads), pytree.leaves(efb)):
            acc = e + g
            c = CMP.compress(acc, phase, levels)
            h, w = CMP.tile_shape(g.numel(), levels)
            check(c.numel() * CMP.n_phases(levels) == h * w,
                  f"{where}: slice of {c.numel()} for a {h}x{w} tile")
            g_hat = CMP.decompress(c, phase, g.shape, levels)
            del c
            # the same transform pair on backend "torch"
            kw = dict(wavelet="cdf97", scheme=CMP.SCHEME, backend="torch",
                      device=device)
            tile, n = CMP._tile_2d(acc, levels)
            del acc
            flat = R.flatten_pyramid(R.dwt2(tile, levels=levels, **kw))
            del tile
            rows_ = flat.shape[0] // CMP.n_phases(levels)
            keep = torch.zeros_like(flat)
            keep[phase * rows_:(phase + 1) * rows_] = \
                flat[phase * rows_:(phase + 1) * rows_]
            del flat
            ref = R.idwt2(R.unflatten_pyramid(keep, levels), **kw)
            del keep
            ref = ref.reshape(-1)[:n].reshape(g.shape)
            cross = max(cross, rel_violation(g_hat, ref,
                                             **CROSS_TOL["float32"]))
            del g_hat, ref
    return seen["worst"], seen["calls"], cross


def check_k1_tiles(E, CMP, tiles, levels, device, where):
    """Every tile's plans fit K1's index math: the tile count under the
    wrapper's int32 guard, each plane's rows, columns and elements under
    2^31 (offsets past the batch are size_t in the kernel).  Returns the
    largest plane's elements."""
    largest = 0
    for t in sorted(set(tiles)):
        plan = E.get_plan(scheme=CMP.SCHEME, levels=levels, shape=t,
                          device=device)
        for spec in plan.level_specs:
            hp, wp = spec.plane_shape
            largest = max(largest, hp * wp)
            check(hp * wp < 2 ** 31, f"{where}: a {hp}x{wp} plane of tile "
                                     f"{t} overflows int32")
            for win in spec.fwd_windows + spec.inv_windows:
                check(win.tiles((1, hp, wp)) < 2 ** 31,
                      f"{where}: tile {t} has {win.tiles((1, hp, wp))} "
                      f"K1 tiles")
    return largest


def phase_lm(torch, R, TW, PW, device, cpu):
    """Phase 3g: qwen2-0.5b trains on the card through
    ``repro_torch.runtime.steps.train_step`` (compressed and plain steps)
    and ``train_loop.train`` (a restart at 2 layers); compression runs K1,
    held bit for bit against its plain version and to CROSS_TOL against
    backend "torch"; prefill + decode against forward.  Returns the
    launches of each kernel it drove."""
    print("== phase 3g: the dense LM training path (qwen2-0.5b, "
          "grad_compression dwt:2)", flush=True)
    import dataclasses
    import math
    import os
    import shutil
    from repro_torch import engine as E
    from repro_torch import pytree
    from repro_torch import telemetry as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import compression as CMP
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models import lm as LMm
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime import train_loop as TL
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sz = LM_REHEARSAL if cpu else LM
    cfg, run = get_config(sz["arch"], smoke=cpu)
    run_c = dataclasses.replace(run, grad_compression="dwt:2",
                                compression_wavelet="cdf97",
                                checkpoint_every=0)
    run_p = dataclasses.replace(run_c, grad_compression="none")
    levels = ST.compression_levels(run_c)
    shape = ShapeConfig("phase3g", "train", sz["seq"], sz["batch"])
    pipe = make_pipeline(cfg, seed=0)
    counts = Launches(TW, PW, cpu, "phase 3g")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = ST.init_train_state(gen, cfg, run_c, device=device)
    # no reference to the first parameters outlives this line: the step
    # returns new ones, and held ones would add to the peak
    shapes = [p.shape for p in pytree.leaves(state.params)]
    n_params = sum(math.prod(s) for s in shapes)
    print(f"{cfg.arch_id}: {n_params:,} parameters in {len(shapes)} "
          f"leaves (n_params() {cfg.n_params():,}); {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.n_heads}->"
          f"{cfg.n_heads_padded}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} padded to "
          f"{pytree.leaves(state.params['embed'])[0].shape[0]}, "
          f"{cfg.dtype} compute on {cfg.param_dtype} parameters; seq "
          f"{sz['seq']}, global batch {sz['batch']}, grad_accum "
          f"{run_c.grad_accum}", flush=True)
    per_step, tiles = _compression_launches(E, CMP, pytree, state.params,
                                            levels, device)
    print(f"compression: {len(tiles)} tiles per step, largest "
          f"{max(tiles)}, K1 launches per compressed step {per_step} "
          f"(sum of the plans' launches, forward and inverse)")

    # -- the main run: compressed steps, then plain ones ----------------
    counts.zero()
    n_steps = sz["compressed"] + sz["plain"]
    state = [state]         # train_rows takes the only reference
    state, rows = train_rows(
        torch, T, ST, state, pipe, shape, cfg,
        [run_c] * sz["compressed"] + [run_p] * sz["plain"], device, sync,
        "phase 3g")
    got = counts.read("main run", sz["compressed"] * per_step)
    no_fallbacks("phase 3g, train steps")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tokens = sz["seq"] * sz["batch"]
    print_rows(rows, tokens)
    print(f"K1 launches per compressed step {per_step}; in the main run "
          f"{got['tap_window']}; peak device memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    steady = rows[1:sz["compressed"]] or rows[:1]    # after the first
    plain = rows[sz["compressed"]:]
    med = lambda rs, k: statistics.median(r.get(k, 0.0) for r in rs)
    print(json.dumps({"phase3g": {
        "params": n_params, "tokens_per_step": tokens,
        "compressed_step_ms": med(steady, "train.step"),
        "compressed_wall_ms": med(steady, "wall_ms"),
        "grads_ms": med(steady, "train.grads"),
        "compress_ms": med(steady, "train.compress"),
        "dwt_ms": statistics.median(sum(r.get(k, 0.0) for k in DWT_SPANS)
                                    for r in steady),
        "adamw_ms": med(steady, "train.adamw"),
        "plain_step_ms": med(plain, "train.step"),
        "plain_wall_ms": med(plain, "wall_ms"),
        "tokens_per_s": tokens / med(steady, "wall_ms") * 1e3,
        "tokens_per_s_plain": tokens / med(plain, "wall_ms") * 1e3,
        "peak_bytes": peak, "k1_per_step": per_step}}))

    # -- where one compressed step's device time goes (torch.profiler) --
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(n_steps, shape).items()}
    counts.zero()
    state = [state]
    state = profile_step(torch, ST, state, batch, cfg, run_c, cuda, sync)
    counts.read("profiled step", per_step)

    # -- one step's real gradients through compression, compared --------
    grads, _ = ST.grads_and_metrics(state.params, batch, cfg, run_c)
    counts.zero()
    worst, n_cmp, cross = hold_k1(torch, R, TW, CMP, pytree, grads,
                                  state.efb, state.step, levels, device,
                                  "phase 3g")
    counts.read("comparison with the plain version", per_step, count=False)
    check(n_cmp == per_step,
          f"phase 3g: {n_cmp} K1 calls compared, expected {per_step}")
    check(worst == 0.0, f"phase 3g: compression's K1 differs from its "
                        f"plain version by {worst}")
    check(cross <= 0.0, f"phase 3g: g_hat on cuda vs torch exceeds "
                        f"CROSS_TOL by {cross}")
    print(f"compression on one step's gradients: {n_cmp} K1 launches vs "
          f"the plain version, max |diff| {worst}; g_hat cuda vs torch "
          f"within CROSS_TOL (worst margin {cross:.3e}); every slice 1/"
          f"{CMP.n_phases(levels)} of its padded tile")

    # K1's share of compression: CUDA events around each K1 launch
    events = []

    def timed(kernel, win, src, **kw):
        if not cuda:
            return kernel(win, src, **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = kernel(win, src, **kw)
        b.record()
        events.append((a, b))
        return out

    counts.zero()
    with k1_calls(TW, timed):
        sync()
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        CMP.compress_with_feedback(grads, state.efb, state.step, levels)
        if cuda:
            end.record()
        sync()
    if cuda:
        total = start.elapsed_time(end)
        k1 = sum(a.elapsed_time(b) for a, b in events)
        print(f"compress_with_feedback alone: {total:.2f} ms (CUDA events), "
              f"of which K1 {k1:.2f} ms over {len(events)} launches "
              f"({100 * k1 / total:.1f}%)")
        print(json.dumps({"phase3g_k1_share": {
            "compress_ms": total, "k1_ms": k1, "k1_launches": len(events)}}))
    counts.read("timed compression", per_step)
    del grads
    no_fallbacks("phase 3g, compression checks")

    # -- prefill + decode against forward, at full width ----------------
    p = sz["prompt"]
    toks = batch["tokens"][:2, :p + 1]
    with torch.no_grad():
        full, _ = LMm.forward(state.params, toks, cfg)
        lg0, cache = ST.prefill_step(state.params, {"tokens": toks[:, :p]},
                                     cfg, 2 * p)
        lg, cache = ST.decode_step(state.params, cache, toks[:, p:p + 1], cfg)
    v = cfg.vocab_size
    lsm = lambda x: torch.log_softmax(x.float()[..., :v], -1)
    err = max(float((lsm(lg0) - lsm(full[:, p - 1])).abs().max()),
              float((lsm(lg) - lsm(full[:, p])).abs().max()))
    check(err < DECODE_TOL, f"phase 3g: prefill/decode vs forward {err}")
    print(f"prefill of {p} tokens + 1 decode step vs forward: max "
          f"|log-softmax diff| {err:.3e} (bound {DECODE_TOL})")
    del state, full, cache, batch
    if cuda:
        torch.cuda.empty_cache()

    # -- restart through train_loop.train, depth cut --------------------
    cfg_r = dataclasses.replace(cfg, n_layers=sz["restart_layers"])
    print(f"restart check: {cfg.arch_id} at full width, depth cut "
          f"{cfg.n_layers} -> {cfg_r.n_layers} layers (a smaller "
          f"checkpoint); {sz['restart_steps']} steps, checkpoint_every=1")
    work = ROOT / "build" / "chip_smoke" / "phase3g"
    shutil.rmtree(work, ignore_errors=True)
    (work / "b").mkdir(parents=True)
    run_r = dataclasses.replace(run_c, checkpoint_every=1,
                                keep_checkpoints=5,
                                checkpoint_dir=str(work / "a"))
    per_step_r = None
    counts.zero()
    try:
        t0 = time.perf_counter()
        first = TL.train(cfg_r, run_r, pipe, shape, sz["restart_steps"],
                         log_every=0, device=device)
        per_step_r, _ = _compression_launches(E, CMP, pytree,
                                              first.state.params, levels,
                                              device)
        first.state = None
        t1 = time.perf_counter()
        # a job killed after step 1's checkpoint restarts from it
        os.symlink(work / "a" / "step_000000001",
                   work / "b" / "step_000000001")
        again = TL.train(cfg_r, dataclasses.replace(
            run_r, checkpoint_dir=str(work / "b")), pipe, shape,
            sz["restart_steps"], log_every=0, device=device)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts.read("restart", (sz["restart_steps"] + len(again.losses))
                * per_step_r)
    check(again.restored_from == 1 and len(again.losses) == 1,
          f"phase 3g: restart from {again.restored_from} ran "
          f"{len(again.losses)} steps")
    a, b = first.losses[-1], again.losses[-1]
    rel = abs(a - b) / abs(a)
    check(rel <= RESTART_RTOL, f"phase 3g: step 3 loss {b} after restart "
                               f"vs {a} uninterrupted (rel {rel})")
    print(f"restart: losses {first.losses} uninterrupted, step 3 after "
          f"restoring step 1's checkpoint {again.losses}; rel diff {rel:.3e}"
          f" ({'bit for bit' if a == b else 'not bit for bit'}); "
          f"{t1 - t0:.1f} s + {t2 - t1:.1f} s with checkpoints")
    no_fallbacks("phase 3g, restart")
    print(f"phase 3g launches (driven paths): {counts.launched}")
    print(f"phase 3g took {time.perf_counter() - t_phase:.1f} s")
    return counts.launched


# phase 3h: the MoE, RWKV6, Mamba2-hybrid and Whisper families at their
# published widths, each cut in depth to fit one card beside its fp32
# parameters, gradients, AdamW moments and error feedback (the SMOKE
# configs, uncut, under --cpu-rehearsal).  Microbatches are cut from each
# arch's RUN.grad_accum so that the global batch of 4 divides
FAMILIES = (dict(arch="mixtral-8x7b", layers=1, seq=4096, batch=4, accum=2),
            dict(arch="rwkv6-3b", layers=2, seq=1024, batch=4, accum=2),
            dict(arch="zamba2-2.7b", layers=12, seq=4096, batch=4, accum=2),
            dict(arch="whisper-medium", layers=None, seq=4096, batch=4,
                 accum=1))
FAMILY_REHEARSAL_SEQ = 32
# the reference's own prefill/decode-vs-forward bounds (tests/test_models.py:43)
FAMILY_DECODE_TOL = {"moe": 2e-2, "encdec": 2e-2, "ssm": 8e-2,
                     "hybrid": 8e-2}


def decode_vs_forward(torch, LMm, ST, params, batch, cfg, prompt):
    """Max |log-softmax| difference between decoding and the full forward:
    prefill ``prompt`` tokens and one decode step (whisper: its prefill
    and 4 decode steps, against ``whisper_forward`` at position 3).  MoE
    configs decode at capacity_factor 8 (tests/test_models.py:23), so no
    token is dropped."""
    import dataclasses
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    v = cfg.vocab_size
    lsm = lambda x: torch.log_softmax(x.float()[..., :v], -1)
    with torch.no_grad():
        if cfg.family == "encdec":
            enc, dec = batch["enc_embeds"][:2], batch["dec_tokens"][:2, :4]
            full, _ = LMm.whisper_forward(params, enc, dec, cfg)
            _, cache = ST.prefill_step(params, {"enc_embeds": enc}, cfg, 0)
            for t in range(4):
                lg, cache = ST.decode_step(params, cache, dec[:, t:t + 1],
                                           cfg)
            return float((lsm(lg) - lsm(full[:, 3])).abs().max())
        toks = batch["tokens"][:2, :prompt + 1]
        full, _ = LMm.forward(params, toks, cfg)
        lg0, cache = ST.prefill_step(params, {"tokens": toks[:, :prompt]},
                                     cfg, 2 * prompt)
        lg, cache = ST.decode_step(params, cache, toks[:, prompt:], cfg)
    return max(float((lsm(lg0) - lsm(full[:, prompt - 1])).abs().max()),
               float((lsm(lg) - lsm(full[:, prompt])).abs().max()))


def phase_families(torch, R, TW, PW, device, cpu):
    """Phase 3h: each family of FAMILIES trains on the card through
    ``runtime.steps.train_step`` (2 compressed steps and 1 plain), one
    step profiled, compression's K1 held bit for bit against its plain
    version on one step's real gradients, and decoding against the
    forward.  Returns the launches of each kernel it drove."""
    print("== phase 3h: the MoE, RWKV6, Mamba2-hybrid and Whisper families "
          "(grad_compression dwt:2)", flush=True)
    import dataclasses
    import math
    from repro_torch import engine as E
    from repro_torch import pytree
    from repro_torch import telemetry as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import compression as CMP
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models import lm as LMm
    from repro_torch.runtime import steps as ST
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counts = Launches(TW, PW, cpu, "phase 3h")
    summary = {}
    if cuda:
        torch.cuda.init()       # the peak-memory reset needs a context
    for fam in FAMILIES:
        t_arch = time.perf_counter()
        arch = fam["arch"]
        where = f"phase 3h, {arch}"
        cfg, run = get_config(arch, smoke=cpu)
        full_layers = cfg.n_layers
        if not cpu and fam["layers"]:
            cfg = dataclasses.replace(cfg, n_layers=fam["layers"])
        seq = FAMILY_REHEARSAL_SEQ if cpu else fam["seq"]
        run_c = dataclasses.replace(run, grad_compression="dwt:2",
                                    compression_wavelet="cdf97",
                                    checkpoint_every=0,
                                    grad_accum=fam["accum"])
        run_p = dataclasses.replace(run_c, grad_compression="none")
        levels = ST.compression_levels(run_c)
        shape = ShapeConfig("phase3h", "train", seq, fam["batch"])
        pipe = make_pipeline(cfg, seed=0)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        gen = torch.Generator(device=device).manual_seed(0)
        state = ST.init_train_state(gen, cfg, run_c, device=device)
        # no reference to the first parameters outlives these lines: the
        # step returns new ones, and held ones would add to the peak
        n_leaves = len(pytree.leaves(state.params))
        n_params = sum(p.numel() for p in pytree.leaves(state.params))
        encdec = cfg.family == "encdec"
        tokens = fam["batch"] * (seq + cfg.max_target_len if encdec
                                 else seq)
        print(f"{arch}: {n_params:,} parameters in {n_leaves} leaves "
              f"(n_params() of the cut config {cfg.n_params():,}); "
              f"{cfg.n_layers} of {full_layers} layers"
              + (f" ({cfg.n_layers // cfg.hybrid_period} shared-attention "
                 f"invocations)" if cfg.hybrid_period else "")
              + f", d_model {cfg.d_model}, d_ff {cfg.d_ff}, family "
              f"{cfg.family}; {'frames' if encdec else 'seq'} {seq}"
              + (f" + {cfg.max_target_len} decoder tokens" if encdec
                 else "")
              + f", global batch {fam['batch']}, grad_accum "
              f"{run_c.grad_accum} (RUN has {run.grad_accum}); "
              f"{24 * n_params / 2 ** 30:.1f} GiB at 24 B/param",
              flush=True)
        per_step, tiles = _compression_launches(E, CMP, pytree, state.params,
                                                levels, device)
        largest = check_k1_tiles(E, CMP, tiles, levels, device, where)
        print(f"compression: {len(tiles)} tiles per step, largest "
              f"{max(tiles)}, largest K1 plane {largest:,} elements (under "
              f"2^31), K1 launches per compressed step {per_step}")

        # -- train: 2 compressed steps, 1 plain ----------------------------
        counts.zero()
        state = [state]     # train_rows takes the only reference
        state, rows = train_rows(torch, T, ST, state, pipe, shape, cfg,
                                 [run_c, run_c, run_p], device, sync, where)
        counts.read(f"{arch} train steps", 2 * per_step)
        no_fallbacks(f"{where}, train steps")
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cfg.is_moe:
            check(all(math.isfinite(r["aux"]) and r["aux"] > 0
                      for r in rows), f"{where}: MoE aux losses "
                                      f"{[r['aux'] for r in rows]}")
        print_rows(rows, tokens)
        print(f"peak device memory {peak / 2 ** 30:.2f} GiB "
              f"(max_memory_allocated)")

        # -- one compressed step in torch.profiler --------------------------
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(3, shape).items()}
        counts.zero()
        state = [state]
        state = profile_step(torch, ST, state, batch, cfg, run_c, cuda, sync,
                             label=f"phase3h_{arch}")
        counts.read(f"{arch} profiled step", per_step)

        # -- K1 on one step's real gradients ------------------------------
        grads, _ = ST.grads_and_metrics(state.params, batch, cfg, run_c)
        counts.zero()
        worst, n_cmp, cross = hold_k1(torch, R, TW, CMP, pytree, grads,
                                      state.efb, state.step, levels, device,
                                      where)
        del grads
        counts.read(f"{arch} comparison with the plain version", per_step,
                    count=False)
        check(n_cmp == per_step,
              f"{where}: {n_cmp} K1 calls compared, expected {per_step}")
        check(worst == 0.0, f"{where}: compression's K1 differs from its "
                            f"plain version by {worst}")
        check(cross <= 0.0, f"{where}: g_hat on cuda vs torch exceeds "
                            f"CROSS_TOL by {cross}")
        print(f"compression on one step's gradients: {n_cmp} K1 launches "
              f"vs the plain version, max |diff| {worst} (the largest tile "
              f"{max(tiles)} included); g_hat cuda vs torch within "
              f"CROSS_TOL (worst margin {cross:.3e})")

        # -- decode against forward ---------------------------------------
        # held in float32 compute: at full width in bfloat16 cuBLAS picks
        # other kernels for the decode's one-token shapes than for the
        # forward's, and their bfloat16 outputs round apart; the
        # configured compute dtype's difference is printed beside it
        tol = FAMILY_DECODE_TOL[cfg.family]
        errs = {dt: decode_vs_forward(torch, LMm, ST, state.params, batch,
                                      dataclasses.replace(cfg, dtype=dt), 16)
                for dt in ("float32", cfg.dtype)}
        err = errs["float32"]
        check(err < tol, f"{where}: decode vs forward {err} (bound {tol})")
        print(("whisper_prefill + 4 decode steps vs whisper_forward" if encdec
               else "prefill of 16 tokens + 1 decode step vs forward")
              + f": max |log-softmax diff| {err:.3e} in float32 compute "
              f"(bound {tol}); {errs[cfg.dtype]:.3e} in {cfg.dtype}")
        no_fallbacks(where)
        del state, batch
        if cuda:
            torch.cuda.empty_cache()

        compressed = rows[1:2]                # after the first step
        summary[arch] = {
            "params": n_params, "layers": cfg.n_layers, "seq": seq,
            "tokens_per_step": tokens, "k1_per_step": per_step,
            "largest_tile": list(max(tiles)),
            "compressed_step_ms": compressed[0].get("train.step", 0.0),
            "grads_ms": compressed[0].get("train.grads", 0.0),
            "compress_ms": compressed[0].get("train.compress", 0.0),
            "dwt_ms": sum(compressed[0].get(k, 0.0) for k in DWT_SPANS),
            "adamw_ms": compressed[0].get("train.adamw", 0.0),
            "compressed_wall_ms": compressed[0]["wall_ms"],
            "plain_step_ms": rows[2].get("train.step", 0.0),
            "plain_wall_ms": rows[2]["wall_ms"],
            "first_step_wall_ms": rows[0]["wall_ms"],
            "tokens_per_s": tokens / compressed[0]["wall_ms"] * 1e3,
            "peak_bytes": peak, "losses": [r["loss"] for r in rows],
            "aux": [r["aux"] for r in rows], "decode_err": errs,
            "k1_max_abs_diff": worst, "seconds": time.perf_counter() - t_arch}
        print(f"{arch} took {summary[arch]['seconds']:.1f} s", flush=True)
    print(json.dumps({"phase3h": summary}))
    print(f"phase 3h launches (driven paths): {counts.launched}")
    print(f"phase 3h took {time.perf_counter() - t_phase:.1f} s")
    return counts.launched


# phase 3i: the multi-device layer over a one-rank mesh (the card is one;
# NCCL refuses two ranks on one device), and the dry run in a process of
# its own (its fake process group cannot share a process with NCCL's)
PODS = dict(arch="qwen2-0.5b", seq=4096, batch=4, steps=2)
PODS_REHEARSAL = dict(PODS, seq=32)
POD_SPANS = ("train.step", "train.grads", "train.compress",
             "train.pod_reduce", "train.adamw")
# the dry run's cells, one process each, all at once: (arch, mesh, extra
# flags), shape train_4k.  On meta DTensors over a 256- or 512-rank fake
# group, qwen2's sharded step takes about a minute of host time on the
# 16x16 mesh and its podwise step as long on 2x16x16, while the sharded
# step on 2x16x16 did not end in 10 minutes (DTensor's redistribution
# planner on a 3-D mesh) and dbrx-132b's 16 microbatches of 40 MoE layers
# would take longer still: those two record their argument bytes alone
DRYRUN_CELLS = (("qwen2-0.5b", "single", ()),
                ("qwen2-0.5b", "multi", ("--podwise", "--tag", "_podwise")),
                ("qwen2-0.5b", "multi", ("--args-only",)),
                ("dbrx-132b", "multi", ("--args-only",)))
DRYRUN_REHEARSAL = (("qwen2-0.5b", "single", ("--smoke",)),
                    ("qwen2-0.5b", "multi", ("--smoke", "--podwise", "--tag",
                                             "_podwise")))
DRYRUN_TIMEOUT = 600


def _equal_trees(pytree, SH, got, want):
    """(leaves compared, the leaves that differ as (path, max |diff|))."""
    bad, n = [], 0
    for (path, a), b in zip(pytree.leaves_with_path(got),
                            pytree.leaves(want)):
        a = SH.to_global(a)
        n += 1
        if not (a.dtype == b.dtype and a.shape == b.shape
                and bool((a == b).all())):
            bad.append((pytree.keystr(path), max_abs(a.float(), b.float())))
    return n, bad


def _dryrun(cpu):
    """The dry-run cells, each in a process of its own, all started at
    once; prints each cell's figures as a JSON line."""
    import os
    out_dir = ROOT / "build" / "chip_smoke" / "phase3i" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = DRYRUN_REHEARSAL if cpu else DRYRUN_CELLS
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh", mesh, "--out", str(out_dir),
         *flags], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for arch, mesh, flags in cells]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"dry run: {len(cells)} cells in {len(cells)} processes, "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    for (arch, mesh, flags), p, (out, err) in zip(cells, procs, outs):
        print("\n".join(ln for ln in out.splitlines()
                        if ln.startswith("[dryrun]")))
        check(p.returncode == 0, f"phase 3i: dry run {arch} {mesh} "
                                 f"{' '.join(flags)} exited {p.returncode}:"
                                 f" {err[-2000:]}")
        tag = "_podwise" if "--podwise" in flags else ""
        res = json.loads((out_dir / f"{arch}__train_4k__{mesh}{tag}.json")
                         .read_text())
        check(res["status"] == "OK", f"phase 3i: dry-run cell {arch} "
                                     f"{mesh} {res['status']}")
        row = {"arch": arch, "mesh": res["mesh"], "flags": " ".join(flags),
               "argument_bytes": res["memory"]["argument_bytes"],
               "run_seconds": res["run_seconds"]}
        if "cost" in res:
            row.update(peak_device_bytes=res["memory"]["peak_device_bytes"],
                       flops_per_device=res["cost"]["flops_per_device"],
                       bytes_major_per_device=res["cost"][
                           "bytes_major_per_device"],
                       wire_bytes=res["collectives"]["total_wire_bytes"],
                       wire_bytes_pod=res["collectives"][
                           "wire_bytes_pod_crossing"],
                       roofline=res["roofline"], dominant=res["dominant"],
                       useful_flops_ratio=res["useful_flops_ratio"])
        print(json.dumps({"phase3i_dryrun": row}))


def phase_multidevice(torch, R, TW, PW, device, cpu):
    """Phase 3i: the sharded and the podwise train steps of qwen2-0.5b at
    full width over a one-rank (pod=1, data=1, model=1) mesh on NCCL
    (gloo and the SMOKE config under --cpu-rehearsal), each held bit for
    bit against the plain ``train_step`` from one seeded state and
    batches; K1 through both, one step's launches against the plain
    version; the pod all-reduce's bytes against the slices' sum; the
    ``train.*`` spans; then the dry run in a subprocess.  Returns the
    launches of each kernel it drove."""
    print("== phase 3i: the multi-device layer (DTensor placements, the "
          "sharded and podwise steps, the dry run)", flush=True)
    import dataclasses
    import math
    import shutil
    import torch.distributed as dist
    from repro_torch import engine as E
    from repro_torch import pytree
    from repro_torch import telemetry as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import compression as CMP
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import steps as ST
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sz = PODS_REHEARSAL if cpu else PODS
    counts = Launches(TW, PW, cpu, "phase 3i")
    work = ROOT / "build" / "chip_smoke" / "phase3i"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if cuda:
        torch.cuda.set_device(device)
    backend = "gloo" if cpu else "nccl"
    dist.init_process_group(backend, init_method=f"file://{work / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, multi_pod=True, n_pods=1,
                               device_type=device.type)
        print(f"process group {backend}, world 1; mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{device}")
        cfg, run = get_config(sz["arch"], smoke=cpu)
        run_c = dataclasses.replace(run, grad_compression="dwt:2",
                                    compression_wavelet="cdf97",
                                    checkpoint_every=0)
        levels = ST.compression_levels(run_c)
        shape = ShapeConfig("phase3i", "train", sz["seq"], sz["batch"])
        pipe = make_pipeline(cfg, seed=0)
        batches = [{k: torch.from_numpy(v).to(device)
                    for k, v in pipe.batch_at(i, shape).items()}
                   for i in range(sz["steps"])]
        gen = torch.Generator(device=device).manual_seed(0)
        state0 = ST.init_train_state(gen, cfg, run_c, device=device)
        per_step, tiles = _compression_launches(
            E, CMP, pytree, state0.params, levels, device)
        grad_bytes = sum(p.numel() * 4 for p in pytree.leaves(state0.params))
        slice_bytes = sum(h * w * 4 // CMP.n_phases(levels)
                          for h, w in tiles)
        print(f"{cfg.arch_id}: {len(tiles)} leaves, seq {sz['seq']}, global "
              f"batch {sz['batch']}, grad_accum {run_c.grad_accum}, "
              f"{run_c.grad_compression}; K1 launches per step {per_step}")

        def run_steps(step_fn, state, label, place_batch=None):
            T.set_mode("spans")
            T.TRACER.clear()
            losses, spans = [], []
            try:
                for b in batches:
                    if place_batch is not None:
                        b = place_batch(b)
                    counts.zero()
                    state, m = step_fn(state, b)
                    losses.append(float(m["loss"]))
                    sync()
                    counts.read(f"{label} step", per_step)
                    row = {}
                    for rec in T.TRACER.records():
                        row[rec.name] = row.get(rec.name, 0.0) \
                            + rec.dur_s * 1e3
                    T.TRACER.clear()
                    spans.append(row)
            finally:
                T.set_mode("counters")
            return state, losses, spans

        # -- the plain step, the reference ------------------------------
        plain = lambda s, b: ST.train_step(s, b, cfg, run_c)
        ref, ref_losses, ref_spans = run_steps(plain, state0, "plain")
        check(all(math.isfinite(x) for x in ref_losses),
              f"phase 3i: plain losses {ref_losses}")

        def held(label, state, losses):
            n, bad = _equal_trees(pytree, SH, state.params, ref.params)
            ne, bad_e = _equal_trees(pytree, SH, state.efb, ref.efb)
            check(losses == ref_losses and not bad and not bad_e,
                  f"phase 3i: the {label} step differs from train_step: "
                  f"losses {losses} vs {ref_losses}; params {bad[:4]}; "
                  f"efb {bad_e[:4]}")
            print(f"{label} step x{len(losses)}: losses {losses} == "
                  f"train_step's; {n} parameter and {ne} efb leaves bit "
                  f"for bit")

        # -- the sharded step: a DTensor state placed by the rules, on the
        # single-pod (data, model) mesh.  On the pod mesh the batch rule
        # shards dim 0 over pod and data at once ([Shard(0), Shard(0)]),
        # which the card's torch 2.11 DTensor refuses for the embedding's
        # index op ("hybrid sharding strategies"); torch 2.13 runs it
        single = mesh["data", "model"]
        shd = SH.make_state_shardings(single, state0, cfg, run_c)
        sharded = SH.distribute_tree(state0, shd)
        placed = lambda b: SH.distribute_tree(
            b, SH.make_batch_shardings(single, b))
        with SH.use_mesh(single):
            out, losses, _ = run_steps(plain, sharded, "sharded", placed)
        held("sharded", out, losses)
        del sharded, out
        shd = SH.make_state_shardings(mesh, state0, cfg, run_c)

        # -- the podwise step: efb plain and pod-local -------------------
        podwise_state = ST.TrainState(
            SH.distribute_tree(state0.params, shd.params),
            SH.distribute_tree(state0.opt, shd.opt), state0.efb,
            state0.step)
        step = ST.make_train_step_podwise(mesh, cfg, run_c)
        seen = dict(worst=0.0, calls=0)

        def podwise(s, b):
            # the first step's K1 calls are held against the plain version
            if seen["calls"]:
                return step(s, b)
            with k1_calls(TW, versus_plain(TW, seen)):
                return step(s, b)

        ST.POD_REDUCE.zero()
        with SH.use_mesh(mesh):
            out, losses, pod_spans = run_steps(podwise, podwise_state,
                                               "podwise")
        held("podwise", out, losses)
        del podwise_state, out
        check(seen["calls"] == per_step,
              f"phase 3i: {seen['calls']} K1 calls compared, expected "
              f"{per_step}")
        check(seen["worst"] == 0.0, f"phase 3i: K1 in the podwise step "
                                    f"differs from its plain version by "
                                    f"{seen['worst']}")
        moved = ST.POD_REDUCE.bytes
        check(moved == sz["steps"] * slice_bytes
              and ST.POD_REDUCE.calls == sz["steps"] * len(tiles),
              f"phase 3i: the pod all-reduce moved {moved} bytes in "
              f"{ST.POD_REDUCE.calls} calls; the slices are "
              f"{sz['steps']} x {slice_bytes} bytes in "
              f"{sz['steps'] * len(tiles)}")
        print(f"podwise step: K1 launches per step {per_step}, one step's "
              f"{seen['calls']} calls vs the plain version max |diff| "
              f"{seen['worst']}; "
              f"pod all-reduce {moved // sz['steps']} bytes per step in "
              f"{ST.POD_REDUCE.calls // sz['steps']} calls == the slices' "
              f"sum, against {grad_bytes} bytes of float32 gradients "
              f"(1/{grad_bytes / (moved // sz['steps']):.2f})")
        no_fallbacks("phase 3i, steps")
        card = "cpu rehearsal" if cpu else nvidia_smi()
        for label, rows in (("plain", ref_spans), ("podwise", pod_spans)):
            last = rows[-1]
            print(f"{label:8s} step device spans (ms, last step): " +
                  ", ".join(f"{k} {last.get(k, 0.0):.2f}"
                            for k in POD_SPANS) + f"  [{card}]")
        print(json.dumps({"phase3i": {
            "card": card, "per_step_k1": per_step,
            "k1_max_abs": seen["worst"],
            "pod_reduce_bytes_per_step": moved // sz["steps"],
            "grad_bytes": grad_bytes, "plain_spans_ms": ref_spans[-1],
            "podwise_spans_ms": pod_spans[-1], "losses": ref_losses}}))
        del ref, state0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work / "pg", ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()

    # -- the dry run, in processes of its own ----------------------------
    _dryrun(cpu)
    shutil.rmtree(work, ignore_errors=True)
    print(f"phase 3i launches (driven paths): {counts.launched}")
    print(f"phase 3i took {time.perf_counter() - t_phase:.1f} s")
    return counts.launched


# phase 3j: the repo's entry points (repro_torch.examples) on the card at
# their own defaults, and the direct scheme oracles at the main path's
# width (tiny sizes through the plain versions under --cpu-rehearsal)
ENTRY = dict(oracle=2048, quickstart=256, codec=512, tiled=(8192, 1024),
             serve=512, train_arch="qwen2-100m", train_steps=300,
             train_batch=8, train_seq=256, demo_steps=120,
             serve_arch="qwen2-0.5b", serve_batch=4, serve_prompt=32,
             serve_new=32)
ENTRY_REHEARSAL = dict(ENTRY, oracle=64, quickstart=64, codec=128,
                       tiled=(256, 64), serve=128, train_arch="qwen2-0.5b",
                       train_steps=20, train_batch=2, train_seq=32,
                       demo_steps=20)
PSNR_DB = 0.01          # tiled against monolithic PSNR rows


def teacher_forced_vs_forward(torch, LMm, SL, out, cfg):
    """Max |log-softmax| difference between the serve example's logits
    with its own greedy tokens fed back (teacher-forced: the prefill's
    and every decode step's) and one full forward over the prompt and
    those tokens, and the largest |logit| of the forward (the scale of
    the compute dtype's rounding).  MoE configs run at capacity_factor 8
    in both, as in :func:`decode_vs_forward`, so that no token is
    dropped."""
    import dataclasses
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p, gen = out["prompts"], torch.from_numpy(out["tokens"]).to(
        out["prompts"].device)
    n = gen.shape[1]
    got = SL.generate(out["params"], cfg, p, n, teacher=gen[:, :n - 1])
    v = cfg.vocab_size
    lsm = lambda x: torch.log_softmax(x.float()[..., :v], -1)
    with torch.no_grad():
        full, _ = LMm.forward(out["params"], torch.cat(
            [p, gen[:, :n - 1].to(p.dtype)], 1), cfg)
    start = p.shape[1] - 1
    return (max(float((lsm(lg) - lsm(full[:, start + i])).abs().max())
                for i, lg in enumerate(got["logits"])),
            float(full.float()[..., :v].abs().max()))


def phase_entry_points(torch, R, TW, PW, device, cpu):
    """Phase 3j: the direct scheme oracles (``schemes.forward``,
    ``optimize.forward_optimized``) at the main path's width against
    ``dwt2`` on K1 and each other, then each module of
    ``repro_torch.examples`` driven on the card at its defaults (the
    quickstart, the codec's sweep, out-of-core and served paths,
    ``train_lm`` plain and compressed, the compression demo, ``serve_lm``
    on mixtral's SMOKE and qwen2-0.5b at full width), each with every
    counter at 0, its K1 launches exact and its results checked.
    Returns the launches of each kernel it drove."""
    print("== phase 3j: the entry points (repro_torch.examples) and the "
          "direct scheme oracles", flush=True)
    import dataclasses
    import shutil
    import numpy as np
    from repro_torch import engine as E
    from repro_torch import pytree
    from repro_torch import serve as SV
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import compression as CMP
    from repro_torch.core import optimize as O
    from repro_torch.core import schemes as S
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.examples import dwt_image_codec as D
    from repro_torch.examples import quickstart as Q
    from repro_torch.examples import serve_lm as SL
    from repro_torch.examples import train_lm as TLx
    from repro_torch.examples import wavelet_compression_demo as WD
    from repro_torch.kernels import ops as K
    from repro_torch.models import lm as LMm
    from repro_torch.runtime import steps as ST
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sz = ENTRY_REHEARSAL if cpu else ENTRY
    counts = Launches(TW, PW, cpu, "phase 3j")
    card = "cpu rehearsal" if cpu else nvidia_smi()
    work = ROOT / "build" / "chip_smoke" / "phase3j"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    summary = {"card": card}
    cross = CROSS_TOL["float32"]

    def step_done(name, t0):
        no_fallbacks(f"phase 3j, {name}")
        summary.setdefault("seconds", {})[name] = time.perf_counter() - t0
        print(f"phase 3j {name} took {summary['seconds'][name]:.1f} s",
              flush=True)

    # -- 1. the direct oracles at the main path's width ------------------
    t0 = time.perf_counter()
    n = sz["oracle"]
    img = torch.randn((n, n), generator=torch.Generator().manual_seed(22)) \
        .to(device)
    counts.zero()
    k1 = 0
    worst = -float("inf")
    print(f"oracles on one {n}x{n} float32 image: schemes.forward and "
          f"optimize.forward_optimized against dwt2(levels=1, "
          f"backend='cuda') and sep-lifting's forward (CROSS_TOL)")
    print(f"  {'wavelet':7s} {'scheme':13s} steps ops_raw ops_opt "
          f"margin_vs_dwt2 margin_vs_sep-lifting")
    for w in WAVELETS:
        lifting = S.forward(img, w, "sep-lifting")
        for s in SCHEMES:
            pyr = R.dwt2(img, wavelet=w, scheme=s, levels=1,
                         backend="cuda", device=device)
            k1 += R.get_plan(wavelet=w, scheme=s, levels=1, shape=(n, n),
                             device=device).launches
            kernel = (pyr.ll,) + tuple(pyr.details[0])
            m_k, m_l = -float("inf"), -float("inf")
            for fn in (S.forward, O.forward_optimized):
                planes = fn(img, w, s)
                check(all(p.device == img.device for p in planes),
                      f"phase 3j: {fn.__name__} left the image's device")
                for a, b, c in zip(planes, kernel, lifting):
                    m_k = max(m_k, rel_violation(a, b, **cross))
                    m_l = max(m_l, rel_violation(a, c, **cross))
                del planes
            check(m_k <= 0 and m_l <= 0,
                  f"phase 3j: {w} {s} oracle beyond CROSS_TOL (vs dwt2 "
                  f"{m_k}, vs sep-lifting {m_l})")
            worst = max(worst, m_k, m_l)
            t1 = O.table1_ops(w, s)
            print(f"  {w:7s} {s:13s} {t1['steps']:5d} {t1['ops_raw']:7d} "
                  f"{t1['ops_optimized']:7d} {m_k:14.3e} {m_l:14.3e}")
    counts.read("oracles' dwt2", k1)
    summary["oracles"] = dict(size=n, pairs=len(WAVELETS) * len(SCHEMES),
                              worst_margin=worst)
    del img, lifting, pyr, kernel
    step_done("oracles", t0)

    # -- 2. the quickstart ------------------------------------------------
    t0 = time.perf_counter()
    n = sz["quickstart"]
    kw3 = dict(wavelet="cdf97", levels=3, shape=(n, n), device=device)
    k1 = sum(2 * R.get_plan(scheme=s, **kw3).launches for s in SCHEMES) \
        + K.scheme_stats("cdf97", "ns-polyconv", True, (n, n))["launches"] \
        + 3 * R.get_plan(scheme="ns-polyconv", fuse="levels",
                         **dict(kw3, shape=(8, n, n))).launches
    counts.zero()
    qs = Q.run(n, device)
    counts.read("quickstart", k1)
    img = Q.make_test_image(n, device)
    for row in qs["schemes"]:
        check(rel_violation(row["rec"], img, **ROUNDTRIP_TOL["float32"])
              <= 0, f"phase 3j: quickstart {row['scheme']} round trip")
        check(rel_violation(row["ll"], qs["schemes"][0]["ll"], **cross)
              <= 0, f"phase 3j: quickstart {row['scheme']} LL vs "
                    f"{qs['schemes'][0]['scheme']}'s")
    stat_keys = ("steps", "launches", "ops", "ops_compiled")
    counts_of = lambda r: (
        [(x["scheme"], x["steps"], x["ops"]) for x in r["schemes"]],
        r["optimized"],
        [[st[k] for k in stat_keys] for st in (r["kernel"]["sep_conv"],
                                               r["kernel"]["ns_conv"])],
        (r["engine"]["steps"], r["engine"]["launches"]))
    print("quickstart's counts on the CPU, for comparison:")
    on_cpu = Q.run(n, "cpu")
    check(counts_of(qs) == counts_of(on_cpu),
          f"phase 3j: quickstart counts differ from the CPU's: "
          f"{counts_of(qs)} vs {counts_of(on_cpu)}")
    eng = qs["engine"]
    check(eng["launches"] == 3, f"phase 3j: batched levels plan launches "
                                f"{eng['launches']}")
    check(eng["stats"]["hits"] == eng["first"]["hits"] + 1
          and eng["stats"]["misses"] == eng["first"]["misses"],
          f"phase 3j: the second batched call missed the plan cache "
          f"({eng['first']} -> {eng['stats']})")
    k_launches = K.scheme_stats("cdf97", "ns-polyconv", True,
                                (n, n))["launches"]
    seen = dict(worst=0.0, calls=0)
    counts.zero()
    with torch.no_grad(), k1_calls(TW, versus_plain(TW, seen)):
        again = K.apply_scheme_cuda(img, wavelet="cdf97",
                                    scheme="ns-polyconv", optimize=True)
    counts.read("quickstart kernel vs plain", k_launches, count=False)
    same = max(max_abs(a, b) for a, b in zip(again, qs["kernel"]["subbands"]))
    check(seen["calls"] == k_launches and seen["worst"] == 0.0
          and same == 0.0,
          f"phase 3j: apply_scheme_cuda vs its plain version: "
          f"{seen['calls']} launches compared, max |diff| {seen['worst']}, "
          f"rerun {same}")
    print(f"quickstart: counts equal the CPU's; the batched 'levels' plan "
          f"{eng['launches']} launches, second call a cache hit; "
          f"apply_scheme_cuda vs its plain version {seen['calls']} "
          f"launches, max |diff| {seen['worst']}")
    summary["quickstart"] = dict(size=n, k1=k1,
                                 kernel_vs_plain=seen["worst"])
    del qs, on_cpu, img, again
    step_done("quickstart", t0)

    # -- 3. the codec: the sweep, out of core, served ----------------------
    t0 = time.perf_counter()
    n = sz["codec"]
    L = 4
    plan = lambda **kw: R.get_plan(levels=L, device=device, **D.CODEC, **kw)
    counts.zero()
    sweep = D.main_sweep(n, L, device)
    counts.read("codec sweep", 7 * plan(shape=(n, n)).launches)
    check(sweep["err"] <= ROUNDTRIP_TOL["float32"]["atol"],
          f"phase 3j: codec round trip {sweep['err']}")
    n, t = sz["tiled"]
    splan = plan(shape=(n, n), tiles=(t, t), fuse="levels")
    k1 = splan.grid.grid_shape[0] * splan.launches \
        + 3 * plan(shape=(n, n), tiles=(t, t)).launches
    counts.zero()
    t1 = time.perf_counter()
    tiled = D.main_tiled(n, t, L, device)
    sync()
    tiled_s = time.perf_counter() - t1
    counts.read("codec out of core", k1)
    counts.zero()
    mono = R.dwt2(tiled["image"], levels=L, fuse="levels", device=device,
                  **D.CODEC)
    d, _ = _planes_np_equal(torch, device, tiled["pyramid"], mono)
    check(d == 0.0, f"phase 3j: streamed pyramid vs monolithic dwt2 off by "
                    f"{d}")
    print("the same keep shares through the monolithic dwt2/idwt2:")
    mono_rows = D.keep_sweep(R.flatten_pyramid(mono), tiled["image"], L,
                             [k for k, _ in tiled["rows"]], device=device)
    counts.read("codec monolithic comparison",
                plan(shape=(n, n), fuse="levels").launches
                + len(mono_rows) * plan(shape=(n, n)).launches, count=False)
    gaps = [abs(a - b) for (_, a), (_, b) in zip(tiled["rows"], mono_rows)]
    check(max(gaps) <= PSNR_DB, f"phase 3j: tiled PSNRs {tiled['rows']} vs "
                                f"monolithic {mono_rows}")
    check(tiled["err"] <= ROUNDTRIP_TOL["float32"]["atol"],
          f"phase 3j: out-of-core round trip {tiled['err']}")
    print(f"out of core: streamed pyramid == monolithic dwt2 bit for bit; "
          f"PSNRs within {max(gaps):.4f} dB of the monolithic path; "
          f"{tiled_s:.2f} s for the codec ({n}x{n}, {t}^2 tiles)")
    del tiled["image"], mono
    if cuda:
        torch.cuda.empty_cache()
    n = sz["serve"]
    SV.reset_metrics()
    counts.zero()
    served = D.main_serve(n, device=device)
    st = served["stats"]
    kw = dict(levels=3, backend="cuda", fuse="levels", device=device,
              **D.CODEC)
    counts.read("codec served", st["batches"] * R.get_plan(
        shape=(1, 64, 64), **kw).launches)
    counts.zero()
    recs = []
    for tile, pyr in zip(served["tiles"], served["pyramids"]):
        d, _ = _planes_np_equal(torch, device, pyr, R.dwt2(
            np.ascontiguousarray(tile), **kw))
        check(d == 0.0, f"phase 3j: a served tile differs from dwt2 by {d}")
        recs.append(R.idwt2(pyr, **{k: v for k, v in kw.items()
                                    if k != "levels"}).cpu().numpy())
    per_row = n // 64
    whole = np.block([recs[r * per_row:(r + 1) * per_row]
                      for r in range(per_row)])
    counts.read("codec served comparison", 2 * len(recs) * R.get_plan(
        shape=(64, 64), **kw).launches, count=False)
    check(np.array_equal(whole, served["reconstruction"]),
          "phase 3j: served reconstruction differs from direct idwt2")
    check(served["err"] <= ROUNDTRIP_TOL["float32"]["atol"],
          f"phase 3j: served round trip {served['err']}")
    print(f"served: {len(served['tiles'])} tiles equal to direct dwt2/idwt2 "
          f"bit for bit; {st['served']} requests in {st['batches']} batches, "
          f"occupancy {st['mean_occupancy']:.3f}")
    summary["codec"] = dict(sweep=sweep["rows"], tiled=tiled["rows"],
                            tiled_monolithic=mono_rows,
                            tiled_seconds=tiled_s,
                            served=served["rows"],
                            served_batches=st["batches"],
                            served_occupancy=st["mean_occupancy"],
                            served_p50_ms=st["p50_ms"],
                            served_p99_ms=st["p99_ms"])
    del tiled, served
    step_done("codec", t0)

    # -- 4. train_lm, plain and compressed ---------------------------------
    t0 = time.perf_counter()
    runs = {}
    for compress in (False, True):
        tag = "compressed" if compress else "plain"
        ckpt = work / f"train_lm_{tag}"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        counts.zero()
        t1 = time.perf_counter()
        out = TLx.run_training(sz["train_steps"], sz["train_arch"],
                               sz["train_batch"], sz["train_seq"], compress,
                               str(ckpt), device=device)
        sync()
        wall = time.perf_counter() - t1
        res = out["result"]
        cfg, run = TLx.configs(sz["train_arch"], sz["train_steps"], compress,
                               str(ckpt))
        levels = ST.compression_levels(run)
        per_step = (_compression_launches(E, CMP, pytree, res.state.params,
                                          levels, device)[0]
                    if compress else 0)
        counts.read(f"train_lm {tag}", sz["train_steps"] * per_step)
        losses = res.losses
        check(len(losses) == sz["train_steps"]
              and all(np.isfinite(losses)),
              f"phase 3j: train_lm {tag} losses {losses}")
        check(out["last10"] < out["first10"],
              f"phase 3j: train_lm {tag} did not decrease: "
              f"{out['first10']} -> {out['last10']}")
        ck = Checkpointer(str(ckpt), keep=run.keep_checkpoints)
        want = sorted({*range(run.checkpoint_every, sz["train_steps"],
                              run.checkpoint_every),
                       sz["train_steps"]})[-run.keep_checkpoints:]
        have = sorted(int(p.name.split("_")[1]) for p in ckpt.glob("step_*")
                      if (p / "COMMITTED").exists())
        check(have == want and ck.latest_step() == sz["train_steps"],
              f"phase 3j: train_lm {tag} checkpoints {have}, want {want}")
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        tokens = sz["train_batch"] * sz["train_seq"]
        runs[tag] = dict(first10=out["first10"], last10=out["last10"],
                         final=losses[-1], ms_per_step=wall / len(losses)
                         * 1e3, tokens_per_s=tokens * len(losses) / wall,
                         peak_bytes=peak, k1_per_step=per_step,
                         checkpoints=have, seconds=wall)
        print(f"train_lm {tag}: {wall / len(losses) * 1e3:.2f} ms/step "
              f"(wall, checkpoints included), "
              f"{tokens * len(losses) / wall:,.0f} tokens/s, peak "
              f"{peak / 2**30:.2f} GiB, K1 per step {per_step}, "
              f"checkpoints {have}  [{card}]")
        if compress:
            # one more step's real gradients through compression, K1 held
            # against its plain version launch by launch
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     make_pipeline(cfg, seed=run.seed).batch_at(
                         sz["train_steps"], ShapeConfig(
                             "train_example", "train", sz["train_seq"],
                             sz["train_batch"])).items()}
            state = res.state
            grads, _ = ST.grads_and_metrics(state.params, batch, cfg, run)
            counts.zero()
            worst, n_cmp, margin = hold_k1(torch, R, TW, CMP, pytree, grads,
                                           state.efb, state.step, levels,
                                           device, "phase 3j, train_lm")
            counts.read("train_lm comparison with the plain version",
                        per_step, count=False)
            check(n_cmp == per_step and worst == 0.0 and margin <= 0.0,
                  f"phase 3j: train_lm K1 vs plain: {n_cmp} of {per_step} "
                  f"calls, max |diff| {worst}, g_hat margin {margin}")
            print(f"train_lm compressed: one step's gradients, {n_cmp} K1 "
                  f"launches vs the plain version, max |diff| {worst}; "
                  f"g_hat cuda vs torch worst margin {margin:.3e}")
            runs[tag]["k1_max_abs_diff"] = worst
            del grads, batch, state
        del out, res
        shutil.rmtree(ckpt, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()
    gap = runs["compressed"]["last10"] - runs["plain"]["last10"]
    print(f"train_lm final-loss gap (compressed - plain, last10): "
          f"{gap:+.4f}")
    summary["train_lm"] = dict(runs, gap=gap, steps=sz["train_steps"])
    step_done("train_lm", t0)

    # -- 5. the compression demo -------------------------------------------
    t0 = time.perf_counter()
    cfg, run = get_config("minitron-8b", smoke=True)
    meta = LMm.init_params(None, cfg, "meta")
    per_step = {lv: _compression_launches(E, CMP, pytree, meta, lv,
                                          device)[0] for lv in (1, 2)}
    counts.zero()
    demo = WD.run_demo(sz["demo_steps"], device, ckpt_root=str(work))
    counts.read("compression demo", sz["demo_steps"] * sum(per_step.values()))
    check(demo["raw_bytes"] == cfg.n_params() * 4
          and demo["dwt2_bytes"] == cfg.n_params() * 4 / 16,
          f"phase 3j: demo bytes {demo['raw_bytes']}, {demo['dwt2_bytes']}")
    mean = statistics.fmean
    for tag, losses in demo["losses"].items():
        check(all(np.isfinite(losses))
              and mean(losses[-10:]) < mean(losses[:10]),
              f"phase 3j: demo {tag} did not decrease: {losses[:10]} ... "
              f"{losses[-10:]}")
    print(f"compression demo: K1 per step {per_step[2]} at dwt:2, "
          f"{per_step[1]} at dwt:1; gaps dwt:2 {demo['gap_dwt2']:+.4f}, "
          f"dwt:1 {demo['gap_dwt1']:+.4f}")
    summary["demo"] = dict(
        steps=sz["demo_steps"], gap_dwt2=demo["gap_dwt2"],
        gap_dwt1=demo["gap_dwt1"], k1_per_step=per_step,
        final={k: mean(v[-10:]) for k, v in demo["losses"].items()})
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    step_done("demo", t0)

    # -- 6. serve_lm: its default, and qwen2-0.5b at full width ------------
    t0 = time.perf_counter()
    summary["serve_lm"] = {}
    for arch, cfg in (("mixtral-8x7b", None),
                      (sz["serve_arch"], get_config(sz["serve_arch"],
                                                    smoke=cpu)[0])):
        counts.zero()
        out = (SL.serve(device=device) if cfg is None else
               SL.serve(batch=sz["serve_batch"],
                        prompt_len=sz["serve_prompt"],
                        new_tokens=sz["serve_new"], device=device, cfg=cfg))
        cfg = out["cfg"]
        errs, scale = {}, {}
        for dt in ("float32", cfg.dtype):
            errs[dt], scale[dt] = teacher_forced_vs_forward(
                torch, LMm, SL, out, dataclasses.replace(cfg, dtype=dt))
        counts.read(f"serve_lm {arch}", 0)
        check(errs["float32"] < DECODE_TOL,
              f"phase 3j: serve_lm {arch} teacher-forced decode vs forward "
              f"{errs}")
        print(f"serve_lm {cfg.arch_id} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}): {out['ms_per_token']:.2f} ms/token; "
              f"teacher-forced decode vs forward max |log-softmax diff| "
              f"{errs['float32']:.3e} in float32 (bound {DECODE_TOL}), "
              f"{errs[cfg.dtype]:.3e} in {cfg.dtype} (largest |logit| "
              f"{scale[cfg.dtype]:.3f}); greedy tokens "
              f"{out['tokens'][0][:8].tolist()} ...  [{card}]")
        summary["serve_lm"][cfg.arch_id] = dict(
            layers=cfg.n_layers, d_model=cfg.d_model,
            ms_per_token=out["ms_per_token"], prefill_s=out["prefill_s"],
            decode_err=errs, max_abs_logit=scale,
            tokens=out["tokens"][0].tolist())
        del out
        if cuda:
            torch.cuda.empty_cache()
    step_done("serve_lm", t0)

    shutil.rmtree(work, ignore_errors=True)
    summary["seconds"]["phase"] = time.perf_counter() - t_phase
    print(json.dumps({"phase3j": summary}))
    print(f"phase 3j launches (driven paths): {counts.launched}")
    print(f"phase 3j took {time.perf_counter() - t_phase:.1f} s")
    return counts.launched


def _pyramid_bytes(PP, pw, h, w):
    """Modelled and unique bytes of one fused-pyramid launch per image."""
    return PP.pyramid_hbm_bytes((h, w), 4, pw.level_blocks,
                                [p.halo for p in pw.programs])


def _time_transforms(torch, R, PP, device, plans, x, timer):
    print("config,transform,backend,launches,ms,image_GB/s,model_bytes,"
          "model_bound_ms")
    times = {}
    for (scheme, fuse), plan in plans.items():
        common = dict(wavelet=MAIN["wavelet"], scheme=scheme, fuse=fuse,
                      device=device)
        # modelled bytes of the kernel path (what the live roofline
        # divides by): one fused-pyramid launch, or every launch's windows
        # and outputs plus the split/merge copy, summed over the levels
        model = {"fwd": plan.executor.hbm_bytes("forward"),
                 "inv": plan.executor.hbm_bytes("inverse")}
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


def serve_trace_only(torch, backend, fuse, tap_opt, size, max_batch):
    """``--serve-trace``: phase 3f's profiler trace alone, in a process of
    its own — a two-worker server warmed by one batch serves two more
    forward batches of ``size``^2 fp32 images at the given configuration
    inside ``torch.profiler``; prints one JSON line with the trace's
    device copies by name, its K2 kernels and the kernels' launches."""
    import asyncio
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import pyramid_window as PW
    from repro_torch.kernels import tap_window as TW
    from repro_torch.serve import (BucketSpec, DwtServer, ServeConfig,
                                   serve_stats)
    rng = np.random.default_rng(18)
    imgs = [rng.standard_normal((size, size)).astype(np.float32)
            for _ in range(3 * max_batch)]
    kw = dict(levels=MAIN["levels"], wavelet=MAIN["wavelet"],
              scheme="ns-polyconv", backend=backend, fuse=fuse,
              tap_opt=tap_opt)
    srv = DwtServer(ServeConfig(max_batch=max_batch, num_workers=2))
    srv.warmup([BucketSpec(shape=(size, size), **kw)])

    async def run():
        async with srv:
            await asyncio.gather(*[srv.submit(im, **kw)
                                   for im in imgs[:max_batch]])
            torch.cuda.synchronize()
            counters = kernels(TW, PW)
            for k in counters.values():
                k.launches = 0
            b0 = serve_stats()["batches"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                await asyncio.gather(*[srv.submit(im, **kw)
                                       for im in imgs[max_batch:]])
                torch.cuda.synchronize()
            return (prof, serve_stats()["batches"] - b0,
                    {n: k.launches for n, k in counters.items()})
    prof, batches, launches = asyncio.run(asyncio.wait_for(run(), 300))
    trace = ROOT / "build" / "chip_smoke" / "serve_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    evs = [e for e in json.loads(trace.read_text()).get("traceEvents", [])
           if e.get("ph") == "X"]
    copies = [e["name"] for e in evs if e.get("cat") == "gpu_memcpy"]
    k2 = sum(1 for e in evs if e.get("cat") == "kernel"
             and KERNEL_SYMBOLS["pyramid_forward"] in e["name"])
    print(json.dumps({"trace": str(trace.relative_to(ROOT)),
                      "batches": batches, "k2": k2, "launches": launches,
                      "copies": {n: copies.count(n)
                                 for n in sorted(set(copies))}}))
    return 0


def host_overhead_only(torch, srcs, device, cpu):
    """``--host-overhead SRC [SRC ...]``: phase 3d's host-overhead step
    alone, for the ``repro_torch`` of each ``src`` (say a parent's
    checkout and this one), all held in this one process and timed
    round by round."""
    trees = [load_tree(src) for src in srcs]
    out = host_overhead(torch, trees, device,
                        torch.Generator().manual_seed(0))
    print(json.dumps({"host_overhead_us": out}))
    print("cpu rehearsal" if cpu else nvidia_smi())
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at tiny sizes through "
                         "the plain versions (no kernel, no timings kept)")
    ap.add_argument("--host-overhead", metavar="SRC", nargs="+",
                    help="only time plan.execute on the host (phase 3d's "
                         "host-overhead step) for the repro_torch package of "
                         "each SRC, another checkout's src/ for one (a tree "
                         "without telemetry is timed as it is)")
    ap.add_argument("--serve-trace", nargs=5, metavar=("BACKEND", "FUSE",
                                                      "TAP_OPT", "SIZE",
                                                      "MAX_BATCH"),
                    help="only phase 3f's profiler trace of a warmed "
                         "server, in this process (the full run starts it "
                         "in a fresh one)")
    args = ap.parse_args(argv)
    import torch
    cpu = args.cpu_rehearsal
    if not cpu and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card (or --cpu-rehearsal)", file=sys.stderr)
        return 2
    device = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if args.serve_trace:
        backend, fuse, tap_opt, size, max_batch = args.serve_trace
        return serve_trace_only(torch, backend, fuse, tap_opt, int(size),
                                int(max_batch))
    if args.host_overhead:
        return host_overhead_only(
            torch, [Path(src).resolve() for src in args.host_overhead],
            device, cpu)
    import repro_torch as R
    from repro_torch import compiler as C
    from repro_torch import telemetry as T
    from repro_torch.compiler import conv as CV
    from repro_torch.kernels import polyphase as PP
    from repro_torch.kernels import pyramid_window as PW
    from repro_torch.kernels import tap_window as TW
    from repro_torch.kernels import rev_lift as RL
    from repro_torch.kernels import temporal_lift as TL
    # the checks below read the defaults: counters on, the plane disarmed
    T.set_mode("counters")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0) if not cpu else 'cpu'}",
          flush=True)
    triton = importlib.util.find_spec("triton")
    print(f"triton: {'found at ' + str(triton.origin) if triton else 'not found'}"
          f" (importlib.util.find_spec)", flush=True)
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    phase_build(TW, PW, TL, RL, cpu)
    max_err = {"tap_window": phase_kernel(torch, C, TW, device, cpu, gen)}
    no_fallbacks("phase 2")
    timer = Timer(torch, device)
    temporal = phase_temporal_kernel(torch, TL, device, cpu, gen, timer)
    max_err["temporal_lift"] = temporal["max_abs_err"]
    no_fallbacks("phase 2c")
    reversible = phase_reversible_kernel(torch, R, RL, device, cpu, gen,
                                         timer)
    max_err["rev_lift"] = reversible["max_abs_err"]
    no_fallbacks("phase 2d")
    n_fold = phase_plane_fold(torch, R, PP, TW, TL, device, cpu, gen, timer)
    no_fallbacks("phase 2e")
    worst = phase_pyramid_kernel(torch, R, PW, device, cpu, gen)
    max_err.update(pyramid_forward=worst["pyramid_forward"],
                   pyramid_inverse=worst["pyramid_inverse"])
    no_fallbacks("phase 2b")
    launched, plans, x = phase_main(torch, R, TW, PW, device, cpu, gen)
    no_fallbacks("phase 3")
    n_k1, n_temporal = phase_workloads(torch, R, TW, PW, CV, device, cpu,
                                       gen, x, timer)
    launched["tap_window"] += n_k1
    no_fallbacks("phase 3c")
    if not cpu:
        want = {"tap_window": 2 * sum(
            v for k, v in EXPECTED_LAUNCHES.items() if k[1] != "pyramid")
            + 2 * sum(PACKET_LAUNCHES.values())
            + 2 * sum(DWT3_LAUNCHES.values()),
            "pyramid_forward": 1, "pyramid_inverse": 1}
        check(launched == want, f"main path launched {launched}, expected "
                                f"{want}")
    launched["tap_window"] += n_fold
    for name, n in phase_telemetry(torch, R, TW, PW, device, cpu, gen, x,
                                   timer).items():
        launched[name] += n
    for name, n in phase_tiling(torch, R, TW, PW, device, cpu, gen, x,
                                timer).items():
        launched[name] += n
    no_fallbacks("phase 3e")
    for name, n in phase_serving(torch, R, TW, PW, device, cpu,
                                 gen).items():
        launched[name] += n
    no_fallbacks("phase 3f")
    for name, n in phase_lm(torch, R, TW, PW, device, cpu).items():
        launched[name] += n
    no_fallbacks("phase 3g")
    for name, n in phase_families(torch, R, TW, PW, device, cpu).items():
        launched[name] += n
    no_fallbacks("phase 3h")
    for name, n in phase_multidevice(torch, R, TW, PW, device, cpu).items():
        launched[name] += n
    no_fallbacks("phase 3i")
    for name, n in phase_entry_points(torch, R, TW, PW, device,
                                      cpu).items():
        launched[name] += n
    no_fallbacks("phase 3j")
    entries = phase_times(torch, R, PP, TW, PW, CV, device, plans, x, timer)
    entries["temporal_lift"] = temporal["entry"]
    # the temporal kernel's launches counted in phases 2c and 3c
    launched["temporal_lift"] = temporal["launches"] + n_temporal
    entries["rev_lift"] = reversible["entry"]
    launched["rev_lift"] = reversible["launches"]
    no_fallbacks("phase 4")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    card = "cpu rehearsal" if cpu else nvidia_smi()
    print(card)
    kernels_line = [dict(name=name, route="cuda", source=SOURCES[name],
                         replaces=TPU_KERNELS[name],
                         launches=launched[name], max_abs_err=max_err[name],
                         **entries[name])
                    for name in ("tap_window", "pyramid_forward",
                                 "pyramid_inverse", "temporal_lift",
                                 "rev_lift")]
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
