"""The rank mesh of the tiling subsystem's ``"dist"`` transport.

:class:`TileMesh` is the counterpart of the reference package's
``make_tile_mesh`` (which builds a JAX device mesh): a 2-D arrangement of the ranks of one
``torch.distributed`` group, one tile per rank, sized like the tile grid
(see :mod:`repro_torch.tiling.exchange`).  Rank ``r`` of the group holds
grid cell ``(r // cols, r % cols)``.

The rest of the reference module (parameter, optimizer and cache
partition rules of the LM substrate's production mesh) waits for the
port of that substrate.
"""
from __future__ import annotations

from typing import Tuple


class TileMesh:
    """``rows x cols`` ranks of ``group`` (None: the default group), one
    tile block each.  Built on every rank after
    ``torch.distributed.init_process_group``; raises unless the group
    has exactly ``rows * cols`` ranks."""

    def __init__(self, rows: int, cols: int, group=None):
        import torch.distributed as dist
        self.rows, self.cols, self.group = int(rows), int(cols), group
        have = dist.get_world_size(group)
        if have != self.rows * self.cols:
            raise ValueError(
                f"tile mesh {rows}x{cols} needs {rows * cols} devices, "
                f"have {have}")
        #: this process's rank in ``group``
        self.rank = dist.get_rank(group)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def coords(self, rank: int) -> Tuple[int, int]:
        """Grid cell ``(row, col)`` of group rank ``rank``."""
        return divmod(rank, self.cols)

    def rank_of(self, row: int, col: int) -> int:
        """Group rank holding grid cell ``(row, col)``."""
        return row * self.cols + col

    def global_rank(self, rank: int) -> int:
        """The default group's rank of group rank ``rank`` (what
        point-to-point operations name their peer by)."""
        if self.group is None:
            return rank
        import torch.distributed as dist
        return dist.get_global_rank(self.group, rank)

