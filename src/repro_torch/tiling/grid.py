"""TileGrid: partition an image into halo-padded tiles, *exactly*.

The 2-D DWT decomposes into independent tile "cores" that communicate
only through fixed-width halos (arXiv:1708.07853): a tile's output
coefficients depend on input samples at most a filter-reach away, so a
tile computed over ``core + halo`` input produces bit-exact core outputs
without seeing the rest of the image.  The halo width is *scheme- and
level-specific* (arXiv:1605.00561 tabulates the per-scheme widths) — and
the compiled tap programs already know it precisely: the per-axis margin
analysis of :meth:`repro_torch.compiler.ir.TapProgram.halo` is the exact
filter reach of one level's whole step chain (e.g. sep-lifting CDF 9/7:
4 plane samples, not the summed per-step 8).

Margin propagation across levels (forward, finest level = 0): level
``l`` consumes its input image with reach ``r_l`` *plane* samples =
``2*r_l`` pixels of the level-``l`` image = ``2^(l+1) * r_l`` pixels of
the original image; a coarser level's requirement doubles again on the
way down.  The exact per-tile input margin in original-image pixels is

    margin = sum_l  2^(l+1) * r_l          (forward)

and the same formula with the inverse programs' reaches gives the
inverse margin (wrap garbage creeping inward through the reconstruction
chain doubles per level in exactly the same way).  Both are rounded up
to a multiple of ``2^levels`` so every tile window starts on a
``2^levels``-aligned image row/column: polyphase phases then line up at
*every* pyramid level and tile outputs are samplewise identical to the
monolithic transform's.

Tiles are indexed row-major; all cores are ``tile`` sized — the last
row/column of tiles may logically overhang the image, which is harmless
under periodic boundary semantics (the overhang wraps to valid
coefficients that stitching discards), so non-dividing tile sizes need
no special casing anywhere downstream.

The margins come from the programs the plan's backend compiles
(:func:`level_reach`), so a backend of this package matches the
reference package's backend that compiles the same programs
(``"torch"``/``"cuda"``/``"conv"`` there are ``"jnp"``/``"pallas"``/
``"xla"``), margin for margin.  Under ``tap_opt="off"`` the reference's
kernel path walks raw matrices, where ``"cuda"`` runs their lowered
walk as programs; the engine then sizes the margins by the summed step
halos (``raw_walk``), as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


def level_reach(spec, inverse: bool = False, raw_walk: bool = False) -> int:
    """Filter reach (plane samples) of one level of a plan, from its
    compiled tap programs when available (per-axis margin analysis; the
    tight width), else — or with ``raw_walk`` — the summed per-step
    matrix halos (tap_opt="off").

    With multiple programs per level (fuse="none": one kernel launch per
    step, each re-padding its planes) the reaches add — garbage creeps
    inward once per launch.
    """
    progs = spec.inv_programs if inverse else spec.fwd_programs
    if progs is not None and not raw_walk:
        return sum(p.halo for p in progs)
    steps = spec.inv_steps if inverse else spec.fwd_steps
    return sum(st.halo for st in steps)


def pyramid_margin(reaches: Sequence[int], levels: int) -> int:
    """Exact tile input margin in original-image pixels for a pyramid
    whose level ``l`` has filter reach ``reaches[l]`` plane samples,
    rounded up to a multiple of ``2^levels`` for phase alignment."""
    exact = sum((1 << (l + 1)) * r for l, r in enumerate(reaches))
    align = 1 << levels
    return -(-exact // align) * align


def validate_geometry(h: int, w: int, levels: int,
                      tiles: Optional[Tuple[int, int]] = None) -> None:
    """Check image *and tile* dims against ``levels`` with actionable
    errors (offending dimension, max feasible levels).  The image half
    is the engine's own
    :func:`repro_torch.engine.plan.validate_image_geometry`; this adds
    the tile-alignment constraints."""
    from repro_torch.engine.plan import (max_feasible_levels,
                                         validate_image_geometry)
    validate_image_geometry(h, w, levels)
    if tiles is None:
        return
    div = 1 << levels
    th, tw = tiles
    if th <= 0 or tw <= 0:
        raise ValueError(f"tile dims must be positive, got {tiles}")
    t_feasible = min(max_feasible_levels(th, tw), max_feasible_levels(h, w))
    for name, n in (("tile H", th), ("tile W", tw)):
        if n % div:
            raise ValueError(
                f"levels={levels} infeasible for tile {th}x{tw}: {name}={n} "
                f"is not divisible by 2^levels={div} (tile cores must stay "
                f"2^levels-aligned at every pyramid level); max feasible "
                f"levels for this tile on a {h}x{w} image is {t_feasible}")


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Resolved tiling of one ``(H, W)`` image for one plan.

    ``tile`` is the core size of every tile (the last row/column of
    cores may overhang the image; stitching clips).  ``margin`` /
    ``inv_margin`` are the forward / inverse per-side halo widths in
    original-image pixels, both multiples of ``2^levels``.
    """

    image_shape: Tuple[int, int]
    tile: Tuple[int, int]
    levels: int
    margin: int
    inv_margin: int

    @property
    def grid_shape(self) -> Tuple[int, int]:
        (h, w), (th, tw) = self.image_shape, self.tile
        return (-(-h // th), -(-w // tw))

    @property
    def count(self) -> int:
        nr, nc = self.grid_shape
        return nr * nc

    @property
    def window_shape(self) -> Tuple[int, int]:
        th, tw = self.tile
        return (th + 2 * self.margin, tw + 2 * self.margin)

    @property
    def inv_window_shape(self) -> Tuple[int, int]:
        th, tw = self.tile
        return (th + 2 * self.inv_margin, tw + 2 * self.inv_margin)

    def core_slice(self, level: int) -> Tuple[slice, slice]:
        """Core region of a *window-pyramid* plane at pyramid ``level``
        (0 = finest): the forward margin and tile edge scaled to that
        level's resolution.  Exact because both are 2^levels-aligned."""
        f = 1 << (level + 1)
        m = self.margin // f
        return (slice(m, m + self.tile[0] // f),
                slice(m, m + self.tile[1] // f))

    def describe(self) -> dict:
        nr, nc = self.grid_shape
        return {"image": self.image_shape, "tile": self.tile,
                "grid": (nr, nc), "tiles": self.count,
                "margin": self.margin, "inv_margin": self.inv_margin,
                "window": self.window_shape}


def build_grid(image_shape: Tuple[int, int], tile: Tuple[int, int],
               levels: int, level_specs: Sequence,
               raw_walk: bool = False) -> TileGrid:
    """Plan the tile grid for one image/plan: validates geometry, derives
    the exact forward/inverse margins from the plan's per-level compiled
    programs (the summed step halos with ``raw_walk``), and clamps
    oversized tiles to the image."""
    h, w = image_shape
    validate_geometry(h, w, levels, tile)
    th, tw = min(tile[0], h), min(tile[1], w)
    fwd = pyramid_margin([level_reach(s, False, raw_walk)
                          for s in level_specs], levels)
    inv = pyramid_margin([level_reach(s, True, raw_walk)
                          for s in level_specs], levels)
    return TileGrid(image_shape=(h, w), tile=(th, tw), levels=levels,
                    margin=fwd, inv_margin=inv)
