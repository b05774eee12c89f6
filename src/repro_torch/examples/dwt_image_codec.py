"""Wavelet image codec — the paper's home application domain.

    PYTHONPATH=src python -m repro_torch.examples.dwt_image_codec
        [--tiles EDGE] [--serve] [--size N]

Multi-level CDF 9/7 transform (the JPEG 2000 lossy wavelet) computed with
the paper's fastest scheme (non-separable polyconvolution), hard
thresholding of detail coefficients, inverse transform; rate/PSNR sweep.

``--tiles EDGE`` switches to the tiled pipeline: the image is written to
an ``np.memmap`` file (standing in for an image too large for device
memory) and the forward transform streams it through the card one
tile-row band at a time (``repro_torch.tiling.stream_dwt2``) — the
*encode* side never materializes the image on the card.  The
reconstruction then demonstrates the in-core tiled API
(``idwt2(..., tiles=...)``), which does hold the full pyramid on the
card.

``--serve`` runs the JPEG 2000-style tiled codec through the serving
runtime (``repro_torch.serve``): the image splits into independent 64x64
tiles — exactly the shape of concurrent codec traffic — and every tile
transform (forward and inverse) is a request to a
:class:`~repro_torch.serve.DwtServer`, which coalesces them into batched
plan executions.  Same coefficients, same PSNR sweep; the serve counters
at the end show how many batches the tile wave collapsed into.

The port of ``examples/dwt_image_codec.py``, with the same flags,
defaults and lines.  What changed in the port:

* the served tiles run on backend ``"cuda"`` (the reference's ``"jnp"``,
  chosen there because Pallas runs interpreted on a CPU; on a CPU
  server ``"cuda"`` runs the kernel's plain version);
* every transform runs eagerly on the card (``device="cuda"``), or on
  the CPU with ``device="cpu"``;
* the memmap is written under the system's temporary directory, as in
  the reference.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (dwt2, flatten_pyramid, idwt2,
                              unflatten_pyramid)
from repro_torch.engine.plan import resolve_device
from repro_torch.engine.pyramid import Pyramid

CODEC = dict(wavelet="cdf97", scheme="ns-polyconv")


def synthetic_photo(n=512, seed=0, device="cuda"):
    """Smooth background + edges + texture: a stand-in for a photograph."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    img = 0.6 * np.sin(3 * np.pi * yy) * np.cos(2 * np.pi * xx)
    img += (xx > 0.5) * 0.5 + (yy > 0.7) * 0.25          # edges
    img += 0.05 * rng.standard_normal((n, n))            # texture
    return torch.as_tensor(img, dtype=torch.float32,
                           device=resolve_device(device))


def psnr(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    peak = float(torch.max(torch.abs(a)))
    return 10 * np.log10(peak ** 2 / mse) if mse > 0 else np.inf


def keep_sweep(flat, ref, levels, keeps, **idwt_kw):
    """Keep the largest ``keep`` share of the flattened pyramid ``flat``
    (zero the rest), invert, and print and return ``(keep, PSNR)`` rows
    against ``ref``; ``idwt_kw`` goes to :func:`idwt2` with the codec's
    wavelet and scheme."""
    mags = torch.sort(flat.abs().reshape(-1)).values
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    print(f"{'keep%':>7s} {'PSNR dB':>9s}")
    rows = []
    for keep in keeps:
        thresh = mags[int((1 - keep) * mags.numel())]
        kept = torch.where(flat.abs() >= thresh, flat, zero)
        rec = idwt2(unflatten_pyramid(kept, levels), **CODEC, **idwt_kw)
        rows.append((keep, psnr(ref, rec)))
        print(f"{keep*100:6.1f}% {rows[-1][1]:9.2f}")
    return rows


def main_sweep(n=512, levels=4, device="cuda"):
    """The codec on an ``n`` x ``n`` image: the PSNR at five keep shares
    and the lossless round trip; returns both."""
    img = synthetic_photo(n, device=device)
    print(f"image {tuple(img.shape)}, CDF 9/7, {levels} levels, ns-polyconv "
          f"scheme (1 step per lifting pair)")
    pyr = dwt2(img, levels=levels, device=device, **CODEC)
    rows = keep_sweep(flatten_pyramid(pyr), img, levels,
                      (0.5, 0.2, 0.1, 0.05, 0.02), device=device)
    rec_full = idwt2(pyr, device=device, **CODEC)
    err = float(torch.max(torch.abs(rec_full - img)))
    print(f"lossless roundtrip max err: {err:.2e}")
    return dict(rows=rows, err=err)


def main_tiled(n: int, tile: int, levels: int = 4, device="cuda"):
    """The out-of-core codec: an ``n`` x ``n`` memmapped image streamed
    through the card in ``tile`` x ``tile`` tiles, reconstructed by the
    in-core tiled inverse; returns the keep-share PSNRs, the lossless
    error, the streamed (host) pyramid and the image (on the device)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image.f32")
        disk = np.memmap(path, dtype=np.float32, mode="w+", shape=(n, n))
        disk[:] = synthetic_photo(n, device="cpu").numpy()  # "too big"
        disk.flush()
        del disk
        img = np.memmap(path, dtype=np.float32, mode="r", shape=(n, n))
        print(f"out-of-core codec: {n}x{n} memmap ({img.nbytes / 2**20:.0f} "
              f"MiB on disk), CDF 9/7, {levels} levels, tile {tile}x{tile}")
        from repro_torch.tiling import stream_dwt2
        pyr = stream_dwt2(img, levels=levels, tiles=(tile, tile),
                          device=dev, **CODEC)
        ref = torch.from_numpy(np.array(img)).to(dev)
        del img
    on_dev = Pyramid(ll=torch.from_numpy(pyr.ll).to(dev),
                     details=[tuple(torch.from_numpy(d).to(dev) for d in dd)
                              for dd in pyr.details])
    rows = keep_sweep(flatten_pyramid(on_dev), ref, levels, (0.2, 0.05),
                      tiles=(tile, tile), device=dev)
    rec_full = idwt2(on_dev, tiles=(tile, tile), device=dev, **CODEC)
    err = float(torch.max(torch.abs(rec_full - ref)))
    print(f"lossless roundtrip max err: {err:.2e}")
    return dict(rows=rows, err=err, pyramid=pyr, image=ref)


def main_serve(n: int, tile: int = 64, levels: int = 3, device="cuda"):
    """The served codec: ``n`` x ``n`` as independent ``tile`` x ``tile``
    tiles, each forward and inverse transform a request to a
    :class:`~repro_torch.serve.DwtServer`; returns the keep-share PSNRs,
    the lossless error, the tiles, their served pyramids, the lossless
    reconstruction and the serve counters."""
    import asyncio

    from repro_torch.serve import BucketSpec, DwtServer, ServeConfig, \
        serve_stats
    kw = dict(backend="cuda", fuse="levels", **CODEC)
    img = synthetic_photo(n, device="cpu").numpy()
    tiles = [img[r:r + tile, c:c + tile]
             for r in range(0, n, tile) for c in range(0, n, tile)]
    print(f"served codec: {n}x{n} as {len(tiles)} independent "
          f"{tile}x{tile} tiles, CDF 9/7, {levels} levels, ns-polyconv; "
          f"every tile transform is a DwtServer request")

    srv = DwtServer(ServeConfig(max_batch=16, max_wait_ms=2.0,
                                device=device))
    srv.warmup([BucketSpec(shape=(tile, tile), levels=levels, **kw)])

    def threshold(pyr, thresh):
        return Pyramid(
            ll=np.where(np.abs(pyr.ll) >= thresh, pyr.ll, 0.0),
            details=[tuple(np.where(np.abs(d) >= thresh, d, 0.0)
                           for d in dd) for dd in pyr.details])

    def assemble(recs):
        out = np.empty_like(img)
        per_row = n // tile
        for i, rec in enumerate(recs):
            r, c = divmod(i, per_row)
            out[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = rec
        return out

    rows = []

    async def run():
        async with srv:
            pyrs = await asyncio.gather(
                *[srv.submit(t, levels=levels, **kw) for t in tiles])
            mags = np.sort(np.concatenate(
                [np.abs(np.asarray(p.ll)).ravel() for p in pyrs] +
                [np.abs(np.asarray(d)).ravel()
                 for p in pyrs for dd in p.details for d in dd]))
            print(f"{'keep%':>7s} {'PSNR dB':>9s}")
            for keep in (0.2, 0.05):
                t = mags[int((1 - keep) * len(mags))]
                recs = await asyncio.gather(
                    *[srv.submit_inverse(threshold(p, t), **kw)
                      for p in pyrs])
                rows.append((keep, psnr(img, assemble(recs))))
                print(f"{keep*100:6.1f}% {rows[-1][1]:9.2f}")
            recs = await asyncio.gather(
                *[srv.submit_inverse(p, **kw) for p in pyrs])
            return pyrs, assemble(recs)

    pyrs, rec_full = asyncio.run(run())
    err = float(np.max(np.abs(rec_full - img)))
    print(f"lossless roundtrip max err: {err:.2e}")
    st = serve_stats()
    print(f"serve counters: {st['served']} requests coalesced into "
          f"{st['batches']} batches (occupancy {st['mean_occupancy']:.2f}),"
          f" p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms")
    return dict(rows=rows, err=err, tiles=tiles, pyramids=pyrs,
                reconstruction=rec_full, stats=st)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiles", type=int, default=None, metavar="EDGE",
                    help="tile edge for the out-of-core streamed pipeline")
    ap.add_argument("--serve", action="store_true",
                    help="push tile transforms through the batching "
                         "server (repro_torch.serve)")
    ap.add_argument("--size", type=int, default=1024,
                    help="image edge for the --tiles/--serve pipelines")
    args = ap.parse_args(argv)
    if args.tiles:
        main_tiled(args.size, args.tiles)
    elif args.serve:
        main_serve(min(args.size, 512))
    else:
        main_sweep()


if __name__ == "__main__":
    main()
