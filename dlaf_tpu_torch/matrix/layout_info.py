"""Local memory-layout descriptions.

A copy of ``dlaf_tpu/matrix/layout_info.py`` (reference
``matrix/layout_info.h:24-156``): how the local part of a distributed
matrix maps onto a linear buffer, as when wrapping user memory. Two
canonical layouts:

* ``col_major_layout(size, block, ld)``: a ScaLAPACK-style column-major
  local matrix with leading dimension ``ld``;
* ``tile_layout(size, block, ld_tile, tiles_per_col)``: tiles stored
  contiguously, the packed layout the 4-D tile storage generalizes.

Pure index math.
"""

from __future__ import annotations

import dataclasses

from ..common.asserts import dlaf_assert
from ..common.index2d import LocalElementSize, LocalTileIndex, TileElementSize
from ..types import ceil_div


@dataclasses.dataclass(frozen=True)
class LayoutInfo:
    """Placement of each local tile in a linear buffer (reference
    ``LayoutInfo``: size, block, tile offsets, min memory)."""

    size: LocalElementSize
    block_size: TileElementSize
    ld_tile: int            # leading dimension inside a tile
    tile_offset_row: int    # linear offset step between vertical tiles
    tile_offset_col: int    # linear offset step between tile columns

    @property
    def nr_tiles(self):
        return (ceil_div(self.size.row, self.block_size.row) if self.size.row else 0,
                ceil_div(self.size.col, self.block_size.col) if self.size.col else 0)

    def tile_offset(self, index: LocalTileIndex) -> int:
        """Buffer offset of tile ``index`` (reference ``LayoutInfo::tileOffset``)."""
        nt = self.nr_tiles
        dlaf_assert(0 <= index.row < max(nt[0], 1) and 0 <= index.col < max(nt[1], 1),
                    f"tile {index} out of {nt}")
        return index.row * self.tile_offset_row + index.col * self.tile_offset_col

    def tile_size_of(self, index: LocalTileIndex) -> TileElementSize:
        return TileElementSize(
            min(self.block_size.row, self.size.row - index.row * self.block_size.row),
            min(self.block_size.col, self.size.col - index.col * self.block_size.col))

    def min_mem_size(self) -> int:
        """Minimum buffer length (reference ``LayoutInfo::minMemSize``)."""
        if self.size.is_empty():
            return 0
        nt = self.nr_tiles
        last = LocalTileIndex(nt[0] - 1, nt[1] - 1)
        sz = self.tile_size_of(last)
        return self.tile_offset(last) + (sz.col - 1) * self.ld_tile + sz.row


def col_major_layout(size: LocalElementSize, block_size: TileElementSize,
                     ld: int) -> LayoutInfo:
    """Column-major local layout (reference ``colMajorLayout``)."""
    dlaf_assert(ld >= max(1, size.row), f"ld {ld} < rows {size.row}")
    return LayoutInfo(size=size, block_size=block_size, ld_tile=ld,
                      tile_offset_row=block_size.row, tile_offset_col=block_size.col * ld)


def tile_layout(size: LocalElementSize, block_size: TileElementSize,
                ld_tile: int | None = None, tiles_per_col: int | None = None) -> LayoutInfo:
    """Packed tile layout (reference ``tileLayout``)."""
    if ld_tile is None:
        ld_tile = max(1, block_size.row)
    nt_row = ceil_div(size.row, block_size.row) if size.row else 0
    if tiles_per_col is None:
        tiles_per_col = nt_row
    dlaf_assert(ld_tile >= min(block_size.row, max(1, size.row)), f"ld_tile {ld_tile} too small")
    dlaf_assert(tiles_per_col >= nt_row, f"tiles_per_col {tiles_per_col} < {nt_row}")
    tile_area = ld_tile * block_size.col
    return LayoutInfo(size=size, block_size=block_size, ld_tile=ld_tile,
                      tile_offset_row=tile_area, tile_offset_col=tile_area * tiles_per_col)
