"""Quickstart: the paper's schemes on an image, all equal, steps halved.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The port of ``examples/quickstart.py``; it prints the same sections and
lines.  What changed in the port:

* the single-level kernel is the CUDA window kernel K1 through
  ``kernels.ops.apply_scheme_cuda`` (the reference's
  ``apply_scheme_pallas(..., block=(64, 128))``; the block is the one
  the shared-memory guard picks), and its heading names it;
* ``pallas_calls`` (of ``scheme_stats`` and of a plan) is ``launches``;
* transforms run eagerly on the card (``device="cuda"``), or on the CPU
  through the kernel's plain version with ``device="cpu"``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import engine as E
from repro_torch.core import dwt2, idwt2
from repro_torch.core import optimize as O
from repro_torch.core import schemes as S
from repro_torch.engine.plan import resolve_device
from repro_torch.kernels import ops as K


def make_test_image(n=256, device="cuda"):
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = (np.sin(8 * np.pi * yy) * np.cos(6 * np.pi * xx)
           + ((yy - 0.5) ** 2 + (xx - 0.5) ** 2 < 0.1))
    return torch.as_tensor(img, dtype=torch.float32,
                           device=resolve_device(device))


def schemes_section(img, device="cuda"):
    """Every scheme's 3-level CDF 9/7 round trip; one row per scheme with
    its steps and ops per level, reconstruction error and LL deviation
    from the first scheme's (and the LL and reconstruction)."""
    print("\n-- the six schemes (paper Sections 2-4), CDF 9/7 --")
    rows, ref = [], None
    for scheme in S.SCHEMES:
        sch = S.build_scheme("cdf97", scheme)
        pyr = dwt2(img, wavelet="cdf97", levels=3, scheme=scheme,
                   device=device)
        rec = idwt2(pyr, wavelet="cdf97", scheme=scheme, device=device)
        err = float(torch.max(torch.abs(rec - img)))
        if ref is None:
            ref = pyr.ll
        dev = float(torch.max(torch.abs(pyr.ll - ref)))
        print(f"  {scheme:13s} steps/level={sch.num_steps}  "
              f"ops/quad={sch.num_ops:3d}  reconstruction_err={err:.2e}  "
              f"vs_ref={dev:.2e}")
        rows.append(dict(scheme=scheme, steps=sch.num_steps,
                         ops=sch.num_ops, err=err, vs_ref=dev, ll=pyr.ll,
                         rec=rec))
    return rows


def optimization_section():
    """Section 5: raw and optimised op counts of the non-separable
    schemes (the steps do not change)."""
    print("\n-- Section 5 optimization: fewer ops, same steps --")
    rows = []
    for scheme in ("ns-conv", "ns-polyconv", "ns-lifting"):
        raw = S.build_scheme("cdf97", scheme)
        opt = O.build_optimized("cdf97", scheme)
        print(f"  {scheme:13s} ops {raw.num_ops:3d} -> {opt.num_ops:3d}  "
              f"(steps {raw.num_steps} unchanged)")
        rows.append(dict(scheme=scheme, ops=raw.num_ops,
                         ops_optimized=opt.num_ops, steps=raw.num_steps,
                         steps_optimized=opt.num_steps))
    return rows


def kernel_section(img):
    """One optimised ns-polyconv level through K1 (on ``img``'s device),
    and the launches and modelled bytes of sep-conv against ns-conv."""
    print("\n-- CUDA window kernel K1 (csrc/tap_window.cu; its plain "
          "version on a CPU tensor) --")
    y = K.apply_scheme_cuda(img, wavelet="cdf97", scheme="ns-polyconv",
                            optimize=True)
    ll, hl, lh, hh = y
    print(f"  kernel subbands: LL{tuple(ll.shape)} HL{tuple(hl.shape)} "
          f"LH{tuple(lh.shape)} HH{tuple(hh.shape)}")
    energy = float((ll.double() ** 2).sum() / (img.double() ** 2).sum())
    print(f"  LL energy fraction: {energy:.3f}")
    shape = tuple(img.shape)
    st = K.scheme_stats("cdf97", "sep-conv", False, shape)
    stn = K.scheme_stats("cdf97", "ns-conv", False, shape)
    print(f"  HBM round trips: sep-conv {st['launches']} vs "
          f"ns-conv {stn['launches']}  (bytes "
          f"{st['hbm_bytes']/1e6:.1f}MB -> {stn['hbm_bytes']/1e6:.1f}MB)")
    return dict(subbands=y, energy=energy, sep_conv=st, ns_conv=stn)


def engine_section(img, device="cuda"):
    """A batch of 8 through one cached ``fuse="levels"`` plan: the round
    trip, the cache counts after the first call and after a second call
    of the same key, and the plan's steps and launches."""
    print("\n-- plan/executor engine: batched, multi-level, cached --")
    batch = torch.stack([img] * 8)             # (8, 256, 256)
    kw = dict(wavelet="cdf97", scheme="ns-polyconv", fuse="levels",
              device=device)
    pyr = dwt2(batch, levels=3, **kw)
    rec = idwt2(pyr, **kw)
    err = float(torch.max(torch.abs(rec - batch)))
    print(f"  batched pyramid: LL{tuple(pyr.ll.shape)}  "
          f"reconstruction_err={err:.2e}")
    first = E.plan_cache_stats()
    dwt2(batch, levels=3, **kw)                # same key -> cache hit
    stats = E.plan_cache_stats()
    print(f"  plan cache: {stats['hits']} hits / {stats['misses']} misses "
          f"({stats['size']} plans resident)")
    plan = E.get_plan(wavelet="cdf97", scheme="ns-polyconv", levels=3,
                      shape=tuple(batch.shape), dtype="float32",
                      backend="cuda", fuse="levels", device=device)
    print(f"  cuda plan: {plan.num_steps} steps -> "
          f"{plan.launches} kernel launches per batch "
          f"(any batch size)")
    return dict(err=err, ll_shape=tuple(pyr.ll.shape), first=first,
                stats=stats, steps=plan.num_steps, launches=plan.launches)


def run(n=256, device="cuda"):
    """Every section on an ``n`` x ``n`` test image; returns what each
    printed."""
    img = make_test_image(n, device)
    print("image:", tuple(img.shape))
    return dict(schemes=schemes_section(img, device),
                optimized=optimization_section(),
                kernel=kernel_section(img),
                engine=engine_section(img, device))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    run()


if __name__ == "__main__":
    main()
