"""Block distribution map of a matrix.

Counterpart of ``dlaf_tpu/matrix/distribution.py`` (reference
``matrix/distribution.h``), cut to what the local path asks: global size,
block size, tile counts and edge-tile sizes. The grid size is kept because
the storage layout is defined over it, but only the 1x1 grid is ported.
"""

from __future__ import annotations

import dataclasses

from ..common.asserts import dlaf_assert
from ..common.index2d import (GlobalElementSize, GlobalTileIndex, GlobalTileSize,
                              GridSize2D, TileElementSize)
from ..types import ceil_div


@dataclasses.dataclass(frozen=True)
class Distribution:
    size: GlobalElementSize
    block_size: TileElementSize
    grid_size: GridSize2D = GridSize2D(1, 1)

    def __post_init__(self):
        dlaf_assert(self.size.is_valid(), f"invalid size {self.size}")
        dlaf_assert(self.block_size.row > 0 and self.block_size.col > 0,
                    f"invalid block size {self.block_size}")
        dlaf_assert(self.grid_size == GridSize2D(1, 1),
                    f"grid {self.grid_size}: only the 1x1 grid is ported")

    @property
    def nr_tiles(self) -> GlobalTileSize:
        return GlobalTileSize(
            ceil_div(self.size.row, self.block_size.row) if self.size.row else 0,
            ceil_div(self.size.col, self.block_size.col) if self.size.col else 0)

    def tile_size_of(self, index: GlobalTileIndex) -> TileElementSize:
        """Extents of a global tile; edge tiles may be short."""
        return TileElementSize(
            min(self.block_size.row, self.size.row - index.row * self.block_size.row),
            min(self.block_size.col, self.size.col - index.col * self.block_size.col))

    def __str__(self) -> str:
        return (f"Distribution(size={self.size}, block={self.block_size}, "
                f"grid={self.grid_size})")
