"""Tiled & streaming DWT subsystem.

Plans and executes the 2-D DWT over a grid of halo-padded tiles instead
of one monolithic plane: the grid planner derives exact per-scheme,
per-level halo margins from the compiled tap programs, the exchange
layer moves halos (in-core mod-indexed gather, or cross-device
``torch.distributed`` neighbour exchange over a rank mesh), and the
streaming executor feeds out-of-core images band by band from host
memory through pinned staging buffers and a copy stream.

Entry points: :func:`dwt2_tiled` / :func:`idwt2_tiled` (or simply
``dwt2(..., tiles=...)``) and :func:`stream_dwt2`.
"""
from repro_torch.tiling.grid import (TileGrid, build_grid, level_reach,
                                     pyramid_margin, validate_geometry)
from repro_torch.tiling.api import dwt2_tiled, idwt2_tiled
from repro_torch.tiling.checkpoint import (BandCheckpoint,
                                           CheckpointMismatch,
                                           open_checkpoint)
from repro_torch.tiling.stream import stream_dwt2

__all__ = [
    "TileGrid", "build_grid", "level_reach", "pyramid_margin",
    "validate_geometry", "dwt2_tiled", "idwt2_tiled", "stream_dwt2",
    "BandCheckpoint", "CheckpointMismatch", "open_checkpoint",
]
