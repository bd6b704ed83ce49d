"""Sub-matrix and sub-panel views.

Port of ``dlaf_tpu/matrix/views.py:24-72`` (reference ``matrix/views.h``):
a view of the sub-matrix starting at a global element offset, and its
one-tile-wide panel form, answering which tile the view starts in, at
which in-tile offset, and what part of each tile it covers. Pure index
math over :class:`.distribution.Distribution`; reduction to band cuts its
sub-panels with it.
"""

from __future__ import annotations

import dataclasses

from ..common.asserts import dlaf_assert
from ..common.index2d import GlobalElementIndex, GlobalTileIndex, TileElementIndex
from .distribution import Distribution


@dataclasses.dataclass(frozen=True)
class SubTileSpec:
    """Origin and extent inside one tile (reference ``SubTileSpec``)."""

    origin_row: int
    origin_col: int
    rows: int
    cols: int


@dataclasses.dataclass(frozen=True)
class SubMatrixView:
    """View of the sub-matrix from a global element offset to the end
    (reference ``matrix/views.h:85``)."""

    dist: Distribution
    offset: GlobalElementIndex

    def __post_init__(self):
        dlaf_assert(self.offset.row >= 0 and self.offset.col >= 0, f"bad offset {self.offset}")

    @property
    def begin_tile(self) -> GlobalTileIndex:
        return self.dist.global_tile_index(self.offset)

    @property
    def origin_in_tile(self) -> TileElementIndex:
        """In-tile element offset of the view's origin."""
        mb, nb = self.dist.block_size.row, self.dist.block_size.col
        return TileElementIndex(self.offset.row % mb, self.offset.col % nb)

    def tile_spec(self, index: GlobalTileIndex) -> SubTileSpec:
        """The part of global tile ``index`` inside the view."""
        ts = self.dist.tile_size_of(index)
        first = self.begin_tile
        origin = self.origin_in_tile
        orow = origin.row if index.row == first.row else 0
        ocol = origin.col if index.col == first.col else 0
        return SubTileSpec(orow, ocol, ts.row - orow, ts.col - ocol)


@dataclasses.dataclass(frozen=True)
class SubPanelView(SubMatrixView):
    """A view at most one tile (or ``width`` columns) wide (reference
    ``matrix/views.h:129``)."""

    width: int = 0

    def cols(self) -> int:
        return min(self.width or self.dist.block_size.col, self.dist.size.col - self.offset.col)
