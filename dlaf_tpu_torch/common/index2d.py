"""Strongly-tagged 2D index/size algebra.

Counterpart of ``dlaf_tpu/common/index2d.py`` (reference
``common/index2d.h``): (row, col) value types whose distinct classes keep
global-element, global-tile, local-tile, local-element, tile-element and
process-grid coordinates apart.
"""

from __future__ import annotations

import dataclasses
from typing import Type

from .asserts import dlaf_assert


@dataclasses.dataclass(frozen=True)
class _Coords2D:
    row: int
    col: int

    def __iter__(self):
        yield self.row
        yield self.col

    def transposed(self):
        return type(self)(self.col, self.row)

    def __str__(self) -> str:
        return f"({self.row}, {self.col})"


class _SizeMixin:
    def is_valid(self) -> bool:
        return self.row >= 0 and self.col >= 0

    def is_empty(self) -> bool:
        return self.row == 0 or self.col == 0

    def linear_size(self) -> int:
        return self.row * self.col


class _IndexMixin:
    def is_valid(self) -> bool:
        return self.row >= 0 and self.col >= 0

    def is_in(self, size) -> bool:
        """True iff this index addresses an element of ``size`` (the
        paired size tag)."""
        dlaf_assert(type(size) is self._size_tag,
                    f"is_in: expected {self._size_tag.__name__}, got {type(size).__name__}")
        return 0 <= self.row < size.row and 0 <= self.col < size.col


def _make_pair(index_name: str, size_name: str) -> tuple[Type, Type]:
    size_cls = type(size_name, (_Coords2D, _SizeMixin), {})
    index_cls = type(index_name, (_Coords2D, _IndexMixin), {"_size_tag": size_cls})
    return index_cls, size_cls


GlobalElementIndex, GlobalElementSize = _make_pair("GlobalElementIndex", "GlobalElementSize")
GlobalTileIndex, GlobalTileSize = _make_pair("GlobalTileIndex", "GlobalTileSize")
LocalTileIndex, LocalTileSize = _make_pair("LocalTileIndex", "LocalTileSize")
LocalElementIndex, LocalElementSize = _make_pair("LocalElementIndex", "LocalElementSize")
TileElementIndex, TileElementSize = _make_pair("TileElementIndex", "TileElementSize")
RankIndex2D, GridSize2D = _make_pair("RankIndex2D", "GridSize2D")
