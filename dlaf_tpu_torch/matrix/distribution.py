"""2-D block-cyclic distribution map of a matrix.

Counterpart of ``dlaf_tpu/matrix/distribution.py`` (reference
``matrix/distribution.h``): given the global size, the block size, the
process-grid size, a rank and the source rank, it answers the index
questions the algorithms ask (global tile <-> local tile <-> owning rank,
local extents, edge-tile sizes). Pure index math over
:mod:`.util_distribution`. ``rank`` is the rank the local queries speak
for; the single controller that drives every rank keeps it at (0, 0) in
the matrices it builds, as the reference does.
"""

from __future__ import annotations

import dataclasses

from ..common.asserts import dlaf_assert
from ..common.index2d import (GlobalElementIndex, GlobalElementSize, GlobalTileIndex,
                              GlobalTileSize, GridSize2D, LocalElementSize, LocalTileIndex,
                              LocalTileSize, RankIndex2D, TileElementSize)
from ..types import ceil_div
from . import util_distribution as ud


@dataclasses.dataclass(frozen=True)
class Distribution:
    size: GlobalElementSize
    block_size: TileElementSize
    grid_size: GridSize2D = GridSize2D(1, 1)
    rank: RankIndex2D = RankIndex2D(0, 0)
    source_rank: RankIndex2D = RankIndex2D(0, 0)

    def __post_init__(self):
        dlaf_assert(self.size.is_valid(), f"invalid size {self.size}")
        dlaf_assert(self.block_size.row > 0 and self.block_size.col > 0,
                    f"invalid block size {self.block_size}")
        dlaf_assert(self.grid_size.row > 0 and self.grid_size.col > 0,
                    f"invalid grid {self.grid_size}")
        dlaf_assert(self.rank.is_in(self.grid_size), f"rank {self.rank} not in {self.grid_size}")
        dlaf_assert(self.source_rank.is_in(self.grid_size),
                    f"source rank {self.source_rank} not in {self.grid_size}")

    @property
    def nr_tiles(self) -> GlobalTileSize:
        return GlobalTileSize(
            ceil_div(self.size.row, self.block_size.row) if self.size.row else 0,
            ceil_div(self.size.col, self.block_size.col) if self.size.col else 0)

    @property
    def local_nr_tiles(self) -> LocalTileSize:
        """Tiles ``rank`` owns along each axis."""
        nt = self.nr_tiles
        return LocalTileSize(
            ud.local_nr_tiles(nt.row, self.grid_size.row, self.rank.row, self.source_rank.row),
            ud.local_nr_tiles(nt.col, self.grid_size.col, self.rank.col, self.source_rank.col))

    @property
    def local_size(self) -> LocalElementSize:
        """Elements ``rank`` owns along each axis."""
        return LocalElementSize(
            ud.local_size(self.size.row, self.block_size.row, self.grid_size.row,
                          self.rank.row, self.source_rank.row),
            ud.local_size(self.size.col, self.block_size.col, self.grid_size.col,
                          self.rank.col, self.source_rank.col))

    def rank_global_tile(self, index: GlobalTileIndex) -> RankIndex2D:
        """Rank owning a global tile."""
        dlaf_assert(index.is_in(self.nr_tiles), f"{index} not in {self.nr_tiles}")
        return RankIndex2D(
            ud.rank_global_tile(index.row, self.grid_size.row, self.source_rank.row),
            ud.rank_global_tile(index.col, self.grid_size.col, self.source_rank.col))

    def local_tile_index(self, index: GlobalTileIndex) -> LocalTileIndex:
        """Local tile index of a global tile that ``rank`` owns."""
        dlaf_assert(self.rank_global_tile(index) == self.rank,
                    f"tile {index} not owned by rank {self.rank}")
        return LocalTileIndex(ud.local_tile_from_global_tile(index.row, self.grid_size.row),
                              ud.local_tile_from_global_tile(index.col, self.grid_size.col))

    def global_tile_index(self, index) -> GlobalTileIndex:
        """From a ``GlobalElementIndex`` (the tile holding it) or a
        ``LocalTileIndex`` of ``rank``."""
        if isinstance(index, GlobalElementIndex):
            return GlobalTileIndex(ud.tile_from_element(index.row, self.block_size.row),
                                   ud.tile_from_element(index.col, self.block_size.col))
        dlaf_assert(isinstance(index, LocalTileIndex), f"bad index type {type(index)}")
        return GlobalTileIndex(
            ud.global_tile_from_local_tile(index.row, self.grid_size.row, self.rank.row,
                                           self.source_rank.row),
            ud.global_tile_from_local_tile(index.col, self.grid_size.col, self.rank.col,
                                           self.source_rank.col))

    def tile_size_of(self, index: GlobalTileIndex) -> TileElementSize:
        """Extents of a global tile; edge tiles may be short."""
        return TileElementSize(
            ud.tile_size_of(index.row, self.size.row, self.block_size.row),
            ud.tile_size_of(index.col, self.size.col, self.block_size.col))

    def single_rank(self) -> bool:
        return self.grid_size == GridSize2D(1, 1)

    def __str__(self) -> str:
        return (f"Distribution(size={self.size}, block={self.block_size}, "
                f"grid={self.grid_size}, rank={self.rank}, src={self.source_rank})")


def assert_slot_aligned(da: Distribution, db: Distribution, rows: bool = False,
                        cols: bool = False, what: str = "operands") -> None:
    """Raise unless the local tile slots of ``da`` and ``db`` address the
    same global tiles along the requested axes (the same grid extent and
    source rank there). The distributed solve and multiply combine one
    operand's per-slot panels with the other's per-slot tiles, which is
    right only under this alignment; a mismatch gives wrong numbers, not
    an error (``dlaf_tpu/matrix/distribution.py:153-184``)."""
    for on, axis, ga, gb, sa, sb in (
            (rows, "row", da.grid_size.row, db.grid_size.row, da.source_rank.row,
             db.source_rank.row),
            (cols, "col", da.grid_size.col, db.grid_size.col, da.source_rank.col,
             db.source_rank.col)):
        if on:
            dlaf_assert(ga == gb and sa == sb,
                        f"{what}: {axis} slots misaligned — grid {axis}s {ga}/{gb}, source "
                        f"{axis}s {sa}/{sb}; distributed algorithms require operands aligned "
                        "on this axis (re-shard one operand, e.g. Matrix.from_global with the "
                        "other's source_rank)")
