"""Halo exchange: materialize ``core + halo`` tile windows, two transports.

* **gather** (intra-device) — the whole image (or subband plane) is
  resident on one device; tile windows are one mod-indexed gather
  (``x[..., ri % H, ci % W]``, PyTorch advanced indexing), which
  realizes periodic boundary semantics and the halo overlap in a single
  op.  Windows stack into a tile axis, so the whole grid runs through
  the engine as one batched plan execution (tiles ride the kernels'
  batch grid dimension).  The index tensors are built once per grid,
  level and device (:class:`WindowIndex`) and kept by the tiled plan's
  executors, so a call copies no index to the card.

* **dist** (cross-device) — each rank of a ``torch.distributed`` group
  holds one tile block of a 2-D rank mesh
  (:class:`repro_torch.distributed.sharding.TileMesh`); halos move by
  point-to-point neighbour exchange (:func:`shard_halo_pad`): edge
  strips along the mesh rows, then column strips of the row-padded
  block (corners arrive transitively).  The cyclic neighbour relation
  *is* the periodic boundary — edge tiles receive their wrap-around
  halo from the opposite side of the mesh.  (The reference package's
  ``jax.lax.ppermute`` inside ``shard_map``.)

Both transports produce samplewise-identical windows; everything
downstream (the per-window transform, core extraction, stitching) is
transport-agnostic.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tiling.grid import TileGrid


def window_indices(n_tiles: int, core: int, margin: int, period: int
                   ) -> np.ndarray:
    """(n_tiles, core + 2*margin) periodic sample indices along one axis:
    tile ``i`` covers ``[i*core - margin, (i+1)*core + margin) mod period``
    (the last tile may overhang; the wrap makes that valid, not garbage).
    """
    base = np.arange(-margin, core + margin)
    return (base[None, :] + core * np.arange(n_tiles)[:, None]) % period


def _axis_indices(grid: TileGrid, level: Optional[int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Row and column window indices of the image (``level=None``, the
    forward margin) or of a subband plane at pyramid ``level`` (the
    inverse margin at that level's resolution)."""
    (h, w), (th, tw) = grid.image_shape, grid.tile
    nr, nc = grid.grid_shape
    if level is None:
        m = grid.margin
        return (window_indices(nr, th, m, h), window_indices(nc, tw, m, w))
    f = 1 << (level + 1)
    m = grid.inv_margin // f
    return (window_indices(nr, th // f, m, h // f),
            window_indices(nc, tw // f, m, w // f))


class WindowIndex:
    """The broadcast ``(ri, ci)`` index tensors of one grid on one
    device, built once per level on first use: ``None`` for the image's
    forward windows, a pyramid level for the inverse's subband planes.
    Tensors are made on the host and copied to the device once."""

    def __init__(self, grid: TileGrid, device):
        self.grid = grid
        self.device = torch.device(device)
        self._idx: Dict[Optional[int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, level: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self._idx.get(level)
        if idx is None:
            ri, ci = _axis_indices(self.grid, level)
            ri_t = torch.from_numpy(ri[:, None, :, None]).to(self.device)
            ci_t = torch.from_numpy(ci[None, :, None, :]).to(self.device)
            idx = self._idx[level] = (ri_t, ci_t)
        return idx


def _gather(x: torch.Tensor, ri: torch.Tensor, ci: torch.Tensor
            ) -> torch.Tensor:
    # (..., H, W)[..., (nr,1,wh,1), (1,nc,1,ww)] -> (..., nr, nc, wh, ww)
    wins = x[..., ri, ci]
    nr, nc, wh, ww = wins.shape[-4:]
    return wins.reshape(*wins.shape[:-4], nr * nc, wh, ww)


def gather_windows(x: torch.Tensor, grid: TileGrid,
                   index: Optional[WindowIndex] = None) -> torch.Tensor:
    """Tile windows of an image ``(..., H, W)`` -> ``(..., T, wh, ww)``.
    ``index`` holds the index tensors on ``x``'s device (built here when
    None)."""
    index = index or WindowIndex(grid, x.device)
    return _gather(x, *index.get(None))


def gather_plane_windows(p: torch.Tensor, grid: TileGrid, level: int,
                         index: Optional[WindowIndex] = None
                         ) -> torch.Tensor:
    """Subband-plane windows for the inverse: plane ``(..., H_l, W_l)`` at
    pyramid level ``level`` (0 = finest) -> ``(..., T, ph, pw)`` with the
    inverse margin scaled to that level's resolution."""
    index = index or WindowIndex(grid, p.device)
    return _gather(p, *index.get(level))


def extract_core(t: torch.Tensor, grid: TileGrid, level: int
                 ) -> torch.Tensor:
    """Slice the exact core out of window-pyramid planes ``(..., ph, pw)``
    at pyramid ``level`` (any leading batch/tile axes)."""
    rs, cs = grid.core_slice(level)
    return t[..., rs, cs]


def _assemble(cores: torch.Tensor, grid: TileGrid, out: Tuple[int, int]
              ) -> torch.Tensor:
    """Lay per-tile cores ``(..., T, ch, cw)`` out on the grid and clip
    the last-row/col overhang to the global ``out`` shape (a contiguous
    tensor)."""
    nr, nc = grid.grid_shape
    ch, cw = cores.shape[-2:]
    lead = cores.shape[:-3]
    cores = cores.reshape(*lead, nr, nc, ch, cw).transpose(-3, -2)
    full = cores.reshape(*lead, nr * ch, nc * cw)
    return full[..., :out[0], :out[1]].contiguous()


def stitch_plane(tiles: torch.Tensor, grid: TileGrid, level: int,
                 inverse: bool = False) -> torch.Tensor:
    """Stitch window-pyramid planes at ``level`` (0 = finest) back into
    the global subband plane; ``inverse=True`` stitches reconstructed
    *image* tiles (level ignored, margins in image pixels)."""
    (h, w), (th, tw) = grid.image_shape, grid.tile
    if inverse:
        m = grid.inv_margin
        return _assemble(tiles[..., m:m + th, m:m + tw], grid, (h, w))
    f = 1 << (level + 1)
    return _assemble(extract_core(tiles, grid, level), grid,
                     (h // f, w // f))


# ---------------------------------------------------------------------------
# Cross-device transport: point-to-point neighbour exchange
# ---------------------------------------------------------------------------

def _exchange(lo: torch.Tensor, hi: torch.Tensor, prev: int, nxt: int,
              mesh, tag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``hi`` (this block's trailing strip) to ``nxt`` and ``lo``
    (its leading strip) to ``prev``; return (the strip from ``prev``,
    the strip from ``nxt``) — the halos before and after this block.

    The two directions carry their own tags, and every rank posts its
    sends and receives in the same order, so the strips stay apart when
    ``prev`` and ``nxt`` are one rank (an axis of 2); NCCL, which matches
    point-to-point operations in order, pairs them the same way.  On an
    axis of 1 the neighbour is this rank and the strips wrap locally."""
    import torch.distributed as dist
    me = mesh.global_rank(mesh.rank)
    if prev == me and nxt == me:
        return hi.clone(), lo.clone()
    hi, lo = hi.contiguous(), lo.contiguous()
    before, after = torch.empty_like(hi), torch.empty_like(lo)
    ops = [dist.P2POp(dist.isend, hi, nxt, mesh.group, tag),
           dist.P2POp(dist.isend, lo, prev, mesh.group, tag + 1),
           dist.P2POp(dist.irecv, before, prev, mesh.group, tag),
           dist.P2POp(dist.irecv, after, nxt, mesh.group, tag + 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return before, after


def shard_halo_pad(block: torch.Tensor, margin: int, mesh) -> torch.Tensor:
    """Pad this rank's tile block ``(..., th, tw)`` with its neighbours'
    halos: edge strips move cyclically along the mesh rows, then column
    strips of the row-padded block (corner halos ride along).  The
    cyclic neighbour relation realizes the periodic boundary.  Every
    rank of ``mesh`` calls this together (point-to-point operations).

    Single-hop exchange: ``margin`` must not exceed the block edge
    (:func:`validate_shard_grid` checks this before the transport runs).
    """
    m = margin
    if m == 0:
        return block
    r, c = mesh.coords(mesh.rank)
    nr, nc = mesh.rows, mesh.cols
    up = mesh.global_rank(mesh.rank_of((r - 1) % nr, c))
    down = mesh.global_rank(mesh.rank_of((r + 1) % nr, c))
    top, bot = _exchange(block[..., :m, :], block[..., -m:, :], up, down,
                         mesh, tag=0)
    block = torch.cat([top, block, bot], dim=-2)
    left = mesh.global_rank(mesh.rank_of(r, (c - 1) % nc))
    right = mesh.global_rank(mesh.rank_of(r, (c + 1) % nc))
    lft, rgt = _exchange(block[..., :, :m], block[..., :, -m:], left, right,
                         mesh, tag=2)
    return torch.cat([lft, block, rgt], dim=-1)


def validate_shard_grid(grid: TileGrid, mesh, inverse: bool = False
                        ) -> None:
    """Dist transport preconditions: the grid divides the image evenly
    (equal shards), the mesh matches the grid, and every exchange is
    single-hop (margin <= tile edge at every level)."""
    (h, w), (th, tw) = grid.image_shape, grid.tile
    nr, nc = grid.grid_shape
    if h % th or w % tw:
        raise ValueError(
            f"dist transport needs an evenly-dividing grid; tile "
            f"{th}x{tw} does not divide image {h}x{w} (use the gather "
            f"transport or an evenly-dividing tile size)")
    for name, have, want in (("rows", mesh.rows, nr), ("cols", mesh.cols,
                                                       nc)):
        if have != want:
            raise ValueError(
                f"mesh axis {name!r} has size {have}, but the tile grid "
                f"is {nr}x{nc}; build the mesh to match the grid")
    m = grid.inv_margin if inverse else grid.margin
    if m > min(th, tw):
        raise ValueError(
            f"halo margin {m} exceeds tile edge {min(th, tw)}: neighbor "
            f"exchange is single-hop; use larger tiles (or the gather "
            f"transport)")
