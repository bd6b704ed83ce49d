"""Strongly-tagged 2D index/size algebra.

Counterpart of ``dlaf_tpu/common/index2d.py`` (reference
``common/index2d.h``): (row, col) value types whose distinct classes keep
global-element, global-tile, local-tile, local-element, tile-element and
process-grid coordinates apart, with the linearization helpers
(:class:`Ordering`, :func:`compute_linear_index`, :func:`compute_coords`)
and the column-major range walk :func:`iterate_range2d`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Type

from .asserts import dlaf_assert


class Ordering(enum.Enum):
    """Linearization order (reference ``common/index2d.h:24-30``)."""

    RowMajor = "row-major"
    ColMajor = "col-major"


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


def compute_linear_index(ordering: Ordering, index, dims) -> int:
    """``index`` linearized inside a box of extents ``dims`` (reference
    ``index2d.h:288-330``)."""
    dlaf_assert(index.is_in(dims) if hasattr(index, "is_in") else True,
                f"linear index out of bounds: {index} in {dims}")
    if ordering is Ordering.RowMajor:
        return index.row * dims.col + index.col
    return index.col * dims.row + index.row


def compute_coords(ordering: Ordering, linear: int, dims, cls):
    """Inverse of :func:`compute_linear_index`: the ``cls`` index of
    ``linear`` (reference ``index2d.h:340-380``)."""
    if ordering is Ordering.RowMajor:
        return cls(linear // dims.col, linear % dims.col)
    return cls(linear % dims.row, linear // dims.row)


def iterate_range2d(begin_or_end, end=None, *, cls=LocalTileIndex) -> Iterator:
    """The ``cls`` indices of a 2-D half-open range in column-major order
    (reference ``common/range2d.h``): ``iterate_range2d(end)`` over
    ``[(0, 0), end)``, ``iterate_range2d(begin, end)`` over ``[begin,
    end)``."""
    if end is None:
        (b_row, b_col), (e_row, e_col) = (0, 0), tuple(begin_or_end)
    else:
        (b_row, b_col), (e_row, e_col) = tuple(begin_or_end), tuple(end)
    for col in range(b_col, e_col):
        for row in range(b_row, e_row):
            yield cls(row, col)
