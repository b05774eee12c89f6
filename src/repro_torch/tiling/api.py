"""Tiled transform API: ``dwt2_tiled`` / ``idwt2_tiled`` + the tiled
plan's executor.

A tiled plan is a thin orchestration layer over the monolithic engine:
the grid planner (:mod:`repro_torch.tiling.grid`) derives exact halo
margins from the plan's compiled tap programs, the exchange layer
(:mod:`repro_torch.tiling.exchange`) materializes ``core + halo``
windows, and every window then runs through an ordinary *monolithic*
window plan — fetched from the same LRU plan cache on every call, with
the tile axis stacked onto the batch dims so the whole grid is one
batched execution.  The window plan inherits the fuse mode, so
``fuse="pyramid"`` on ``"cuda"`` runs every tile window through the
fused-pyramid kernel: the whole tiled multi-level transform is one K2
(or K3) launch.  Because the window transform executes the very same
compiled programs elementwise, tile cores are bit-identical to the
monolithic transform.

PyTorch runs eagerly, so every fuse mode runs its executor eagerly (the
reference ``jax.jit``\\ s the ``"levels"`` path).  Each call runs in three
spans — ``tile.halo_gather`` (the ``tiling.halo_gather`` fault site sits
inside it), ``tile.window_transform`` and ``tile.stitch`` — timed on the
card for a CUDA plan (:func:`repro_torch.telemetry.device_span`).

Transports:

* ``"gather"`` (default) — in-core, any batch shape, any tile size
  (non-dividing tiles wrap harmlessly); plans cache under ``PlanKey``
  with the ``tiles`` field set, so ``dwt2(..., tiles=...)`` traffic pays
  zero rebuild cost exactly like monolithic traffic.
* ``"dist"`` — SPMD over a ``torch.distributed`` group arranged as a
  :class:`~repro_torch.distributed.sharding.TileMesh`: every rank calls
  with its *own* ``(th, tw)`` block of the image (or its blocks of the
  pyramid, for the inverse) and gets its own core blocks back; halos
  move by point-to-point neighbour exchange and each rank transforms
  only its own window.  Requires an evenly-dividing grid matching the
  mesh and single-hop margins (margin <= tile edge).  The reference's
  ``"shard_map"`` transport instead takes one global array sharded over
  a device mesh and returns a sharded global pyramid.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import engine as E
from repro_torch import telemetry as T
from repro_torch.engine import executor as X
from repro_torch.engine.pyramid import Pyramid
from repro_torch.faults import inject as FI
from repro_torch.tiling import exchange as EX

TRANSPORTS = ("gather", "dist")


def _window_plan(key, shape):
    """Monolithic plan for the stacked tile windows, via the plan cache."""
    return E.get_plan(wavelet=key.wavelet, scheme=key.scheme,
                      levels=key.levels, shape=shape, dtype=key.dtype,
                      backend=key.backend, optimize=key.optimize,
                      fuse=key.fuse, boundary=key.boundary,
                      compute_dtype=key.compute_dtype, tap_opt=key.tap_opt,
                      device=key.device)


def window_plan(plan, op: str = "forward"):
    """The window plan one ``op`` execution of tiled ``plan`` runs: the
    grid's windows (inverse margins for ``"inverse"``) stacked onto the
    plan's batch dims, fetched from the plan cache."""
    return plan.executor.window_plan(op)


class Tiled(X.Executor):
    """A tiled plan: gather the tile windows, run them as one batched
    execution of a monolithic window plan, stitch the per-level cores.
    Its launches, MACs and kernels to build are its window plans'.  The
    index tensors are built and the window plans fetched at first use: a
    plan fetched only for its grid geometry (stream_dwt2, the dist
    transport) builds neither."""

    def __init__(self, plan, backend):
        super().__init__(plan, backend)
        self.grid = plan.grid
        self.index = EX.WindowIndex(self.grid, self.key.device)

    def window_plan(self, op: str = "forward"):
        key, grid = self.key, self.grid
        wshape = (grid.inv_window_shape if op == "inverse"
                  else grid.window_shape)
        return _window_plan(key, key.shape[:-2] + (grid.count,) + wshape)

    def forward(self, x):
        """Gather windows -> batched window transform -> stitch per-level
        cores."""
        key, grid = self.key, self.grid
        levels = key.levels
        wplan = self.window_plan("forward")
        with T.device_span("tile.halo_gather", key.device, op="forward",
                           tiles=grid.count):
            FI.maybe_inject("tiling.halo_gather", op="forward",
                            tiles=grid.count)
            wins = EX.gather_windows(x, grid, self.index)
        with T.device_span("tile.window_transform", key.device,
                           op="forward", tiles=grid.count,
                           backend=key.backend):
            wll, wdetails = wplan.run("forward", wins)
        with T.device_span("tile.stitch", key.device, op="forward",
                           tiles=grid.count):
            ll = EX.stitch_plane(wll, grid, levels - 1)
            details = tuple(
                tuple(EX.stitch_plane(d, grid, levels - 1 - k)
                      for d in det)
                for k, det in enumerate(wdetails))
        return ll, details

    def inverse(self, ll, details):
        """Gather per-level subband windows (inverse margins) -> batched
        window inverse -> stitch image cores."""
        key, grid = self.key, self.grid
        levels = key.levels
        wplan = self.window_plan("inverse")
        with T.device_span("tile.halo_gather", key.device, op="inverse",
                           tiles=grid.count):
            FI.maybe_inject("tiling.halo_gather", op="inverse",
                            tiles=grid.count)
            wll = EX.gather_plane_windows(ll, grid, levels - 1, self.index)
            wdet = tuple(
                tuple(EX.gather_plane_windows(d, grid, levels - 1 - k,
                                              self.index)
                      for d in det)
                for k, det in enumerate(details))
        with T.device_span("tile.window_transform", key.device,
                           op="inverse", tiles=grid.count,
                           backend=key.backend):
            xw = wplan.run("inverse", wll, wdet)
        with T.device_span("tile.stitch", key.device, op="inverse",
                           tiles=grid.count):
            return EX.stitch_plane(xw, grid, 0, inverse=True)

    def launches(self) -> int:
        return self.window_plan("forward").launches

    def macs(self, op: str = "forward"):
        return self.window_plan(op).executor.macs(op)

    def hbm_bytes(self, op: str = "forward") -> int:
        """The window plan's modelled bytes, plus the halo gather — the
        image (forward) or the pyramid's planes (inverse) read once,
        every window written once — plus the stitch — every tile's core
        read once, the pyramid's planes (forward) or the image (inverse)
        written once.  A pyramid holds as many samples as its image, and
        the cores of a grid as many as the grid covers (``T x th x tw``,
        overhang included)."""
        key, grid = self.key, self.grid
        itemsize = getattr(torch, key.dtype).itemsize
        h, w = key.shape[-2:]
        lead = math.prod(key.shape[:-2])
        (th, tw), tiles = grid.tile, grid.count
        image = lead * h * w
        cores = lead * tiles * th * tw
        if op == "inverse":
            mi, L = grid.inv_margin, key.levels
            sizes = [(th >> (l + 1)) + 2 * (mi >> (l + 1)) for l in range(L)]
            sizes_w = [(tw >> (l + 1)) + 2 * (mi >> (l + 1))
                       for l in range(L)]
            per_tile = (sum(3 * a * b for a, b in zip(sizes, sizes_w))
                        + sizes[-1] * sizes_w[-1])
        else:
            wh, ww = grid.window_shape
            per_tile = wh * ww
        windows = lead * tiles * per_tile
        return (self.window_plan(op).executor.hbm_bytes(op)
                + (image + windows + cores + image) * itemsize)

    def prepare(self, device) -> None:
        for op in ("forward", "inverse"):
            self.window_plan(op).prepare()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _check_transport(transport: str) -> None:
    if transport == "shard_map":
        raise ValueError(
            "transport 'shard_map' is the reference package's name; in "
            "repro_torch the cross-device transport is 'dist' "
            "(torch.distributed point-to-point)")
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; "
                         f"available: {TRANSPORTS}")


def dwt2_tiled(x, wavelet: str = "cdf97", levels: int = 1,
               scheme: str = "ns-polyconv", *,
               tiles: Tuple[int, int] = (256, 256),
               optimize: bool = False, backend: str = "cuda",
               fuse: str = "none", boundary: str = "periodic",
               compute_dtype: str = "float32", tap_opt: str = "full",
               transport: str = "gather", mesh=None,
               device="cuda") -> Pyramid:
    """Forward 2-D DWT over a grid of ``tiles``-sized halo-padded tiles.

    Equivalent to ``dwt2(x, ..., tiles=tiles)`` for the default gather
    transport; ``transport="dist"`` instead runs one tile per rank of
    ``mesh`` (a :class:`~repro_torch.distributed.sharding.TileMesh`
    sized like the tile grid): ``x`` is then this rank's ``(th, tw)``
    block and the result its core blocks.  Tile cores match the
    monolithic transform samplewise, including non-dividing tile sizes.

    >>> import torch
    >>> from repro_torch import dwt2, dwt2_tiled
    >>> x = torch.arange(64.0 * 64).reshape(64, 64)
    >>> tiled = dwt2_tiled(x, wavelet="cdf97", levels=2, tiles=(32, 32),
    ...                    backend="torch", device="cpu")
    >>> mono = dwt2(x, wavelet="cdf97", levels=2, backend="torch",
    ...             device="cpu")
    >>> tuple(tiled.ll.shape), bool(torch.equal(tiled.ll, mono.ll))
    ((16, 16), True)
    """
    _check_transport(transport)
    if transport == "gather":
        from repro_torch.core import transform as TR
        return TR.dwt2(x, wavelet=wavelet, levels=levels, scheme=scheme,
                       optimize=optimize, backend=backend, fuse=fuse,
                       boundary=boundary, compute_dtype=compute_dtype,
                       tap_opt=tap_opt, tiles=tiles, device=device)
    return _dwt2_dist(x, wavelet, levels, scheme, tiles, optimize, backend,
                      fuse, boundary, compute_dtype, tap_opt, mesh, device)


def idwt2_tiled(pyr: Pyramid, wavelet: str = "cdf97",
                scheme: str = "ns-polyconv", *,
                tiles: Tuple[int, int] = (256, 256),
                optimize: bool = False, backend: str = "cuda",
                fuse: str = "none", boundary: str = "periodic",
                compute_dtype: str = "float32", tap_opt: str = "full",
                transport: str = "gather", mesh=None,
                device="cuda") -> torch.Tensor:
    """Inverse of :func:`dwt2_tiled` (shares its plan through the cache);
    under ``transport="dist"`` ``pyr`` holds this rank's blocks and the
    result is its ``(th, tw)`` image block."""
    _check_transport(transport)
    if transport == "gather":
        from repro_torch.core import transform as TR
        return TR.idwt2(pyr, wavelet=wavelet, scheme=scheme,
                        optimize=optimize, backend=backend, fuse=fuse,
                        boundary=boundary, compute_dtype=compute_dtype,
                        tap_opt=tap_opt, tiles=tiles, device=device)
    return _idwt2_dist(pyr, wavelet, scheme, tiles, optimize, backend, fuse,
                       boundary, compute_dtype, tap_opt, mesh, device)


# ---------------------------------------------------------------------------
# dist transport (cross-device, SPMD)
# ---------------------------------------------------------------------------

def _dist_setup(block_shape, dtype, wavelet, levels, scheme, tiles,
                optimize, backend, fuse, boundary, compute_dtype, tap_opt,
                mesh, device, inverse: bool):
    """The tiled plan of the global image (for its grid) and the window
    plan every rank runs, after the transport's preconditions."""
    from repro_torch.core.transform import _dtype_name
    if mesh is None:
        raise ValueError("transport='dist' requires a mesh (a TileMesh of "
                         "the ranks, sized like the tile grid)")
    if len(block_shape) != 2:
        raise ValueError(f"dist transport holds one (th, tw) block of a "
                         f"single (H, W) image per rank, got shape "
                         f"{tuple(block_shape)}")
    th, tw = (int(n) for n in block_shape)
    if (th, tw) != (int(tiles[0]), int(tiles[1])):
        raise ValueError(f"dist transport: this rank's block is {th}x{tw}, "
                         f"the tiles are {tiles[0]}x{tiles[1]}")
    shape = (mesh.rows * th, mesh.cols * tw)
    plan = E.get_plan(wavelet=wavelet, scheme=scheme, levels=levels,
                      shape=shape, dtype=_dtype_name(dtype),
                      backend=backend, optimize=optimize, fuse=fuse,
                      boundary=boundary, compute_dtype=compute_dtype,
                      tap_opt=tap_opt, tiles=tiles, device=device)
    grid = plan.grid
    EX.validate_shard_grid(grid, mesh, inverse=inverse)
    wshape = grid.inv_window_shape if inverse else grid.window_shape
    return grid, _window_plan(plan.key, wshape)


def _dwt2_dist(x, wavelet, levels, scheme, tiles, optimize, backend, fuse,
               boundary, compute_dtype, tap_opt, mesh, device):
    from repro_torch.core.transform import _device, _on
    dev = _device(device)
    x = _on(x, dev)
    grid, wplan = _dist_setup(x.shape, x.dtype, wavelet, levels, scheme,
                              tiles, optimize, backend, fuse, boundary,
                              compute_dtype, tap_opt, mesh, dev, False)
    win = EX.shard_halo_pad(x, grid.margin, mesh)
    wll, wdetails = wplan.run("forward", win)
    ll = EX.extract_core(wll, grid, levels - 1).contiguous()
    details = [tuple(EX.extract_core(d, grid, levels - 1 - k).contiguous()
                     for d in det)
               for k, det in enumerate(wdetails)]
    return Pyramid(ll=ll, details=details)


def _idwt2_dist(pyr, wavelet, scheme, tiles, optimize, backend, fuse,
                boundary, compute_dtype, tap_opt, mesh, device):
    from repro_torch.core.transform import _device, _on
    dev = _device(device)
    levels = pyr.levels
    ll = _on(pyr.ll, dev)
    block = (ll.shape[-2] << levels, ll.shape[-1] << levels)
    grid, wplan = _dist_setup(block, ll.dtype, wavelet, levels, scheme,
                              tiles, optimize, backend, fuse, boundary,
                              compute_dtype, tap_opt, mesh, dev, True)
    (th, tw), mi = grid.tile, grid.inv_margin
    wll = EX.shard_halo_pad(ll, mi >> levels, mesh)
    wdet = tuple(
        tuple(EX.shard_halo_pad(_on(d, dev), mi >> (levels - k), mesh)
              for d in det)
        for k, det in enumerate(pyr.details))
    xw = wplan.run("inverse", wll, wdet)
    return xw[mi:mi + th, mi:mi + tw].contiguous()
