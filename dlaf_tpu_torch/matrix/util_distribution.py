"""Pure 1-D block-cyclic index conversions.

A copy of ``dlaf_tpu/matrix/util_distribution.py`` (reference
``matrix/util_distribution.h:28-140``): stateless per-axis functions
between global elements, global tiles, local tiles, tile-local elements and
owning ranks of a block-cyclic distribution with a source-rank offset.
:class:`.distribution.Distribution` composes them into the 2-D map.

Conventions (the reference's, and ScaLAPACK's):

* global tile ``i`` is owned by rank ``(src_rank + i) % grid_size``;
* the local tile index of an owned global tile ``i`` is ``i // grid_size``;
* the last global tile may be smaller than ``tile_size``.
"""

from __future__ import annotations

from ..types import ceil_div


def tile_from_element(element: int, tile_size: int) -> int:
    """Global tile index containing a global element."""
    return element // tile_size


def tile_element_from_element(element: int, tile_size: int) -> int:
    """Index inside its tile of a global element."""
    return element % tile_size


def element_from_tile_and_tile_element(tile: int, tile_element: int, tile_size: int) -> int:
    """Global element from a (tile, in-tile) pair."""
    return tile * tile_size + tile_element


def rank_global_tile(tile: int, grid_size: int, src_rank: int) -> int:
    """Rank owning global tile ``tile``."""
    return (src_rank + tile) % grid_size


def local_tile_from_global_tile(tile: int, grid_size: int) -> int:
    """Local tile index of an OWNED global tile (meaningful only on the rank
    :func:`rank_global_tile` returns)."""
    return tile // grid_size


def next_local_tile_from_global_tile(tile: int, grid_size: int, rank: int,
                                     src_rank: int) -> int:
    """Smallest local tile index on ``rank`` whose global tile is >= ``tile``;
    the rank's local tile count when it owns none at or past ``tile``."""
    r = (rank - src_rank) % grid_size
    return max(0, -(-(tile - r) // grid_size))


def global_tile_from_local_tile(local_tile: int, grid_size: int, rank: int,
                                src_rank: int) -> int:
    """Global tile index of local tile ``local_tile`` on ``rank``."""
    return local_tile * grid_size + (rank - src_rank) % grid_size


def local_nr_tiles(nr_tiles: int, grid_size: int, rank: int, src_rank: int) -> int:
    """Number of local tiles on ``rank`` for ``nr_tiles`` global tiles."""
    return next_local_tile_from_global_tile(nr_tiles, grid_size, rank, src_rank)


def tile_size_of(tile: int, size: int, tile_size: int) -> int:
    """Extent of global tile ``tile`` on an axis of ``size`` elements."""
    return min(tile_size, size - tile * tile_size)


def local_size(size: int, tile_size: int, grid_size: int, rank: int, src_rank: int) -> int:
    """Number of local elements on ``rank`` along an axis."""
    nt = ceil_div(size, tile_size) if size > 0 else 0
    ln = local_nr_tiles(nt, grid_size, rank, src_rank)
    if ln == 0:
        return 0
    last_global = global_tile_from_local_tile(ln - 1, grid_size, rank, src_rank)
    return (ln - 1) * tile_size + tile_size_of(last_global, size, tile_size)
