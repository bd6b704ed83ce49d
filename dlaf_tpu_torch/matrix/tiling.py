"""Layout transforms between a global matrix and tile storage.

Counterpart of ``dlaf_tpu/matrix/tiling.py``. A matrix lives in ONE 4-D
tile storage tensor of shape ``(P*ltr, Q*ltc, mb, nb)``, the reference's
layout, so the two packages can be compared storage to storage. On the 1x1
grid of this port the storage index of a tile is its global tile index,
and edge tiles are zero-padded to full ``(mb, nb)``.
"""

from __future__ import annotations

import torch

from ..types import ceil_div
from .distribution import Distribution


def storage_tile_grid(dist: Distribution) -> tuple[int, int, int, int]:
    """(P*ltr, Q*ltc, ltr, ltc): storage tile-grid extents and the
    per-rank local tile counts."""
    nt = dist.nr_tiles
    P, Q = dist.grid_size.row, dist.grid_size.col
    ltr = ceil_div(nt.row, P) if nt.row else 0
    ltc = ceil_div(nt.col, Q) if nt.col else 0
    return P * ltr, Q * ltc, ltr, ltc


def global_to_tiles(a: torch.Tensor, dist: Distribution) -> torch.Tensor:
    """Global ``(m, n)`` tensor -> tile storage ``(ntr, ntc, mb, nb)``,
    on ``a``'s device."""
    m, n = dist.size.row, dist.size.col
    mb, nb = dist.block_size.row, dist.block_size.col
    nt = dist.nr_tiles
    t = a.new_zeros((nt.row * mb, nt.col * nb))
    t[:m, :n] = a
    return t.reshape(nt.row, mb, nt.col, nb).permute(0, 2, 1, 3).contiguous()


def tiles_to_global(t: torch.Tensor, dist: Distribution) -> torch.Tensor:
    """Tile storage -> a new contiguous global ``(m, n)`` tensor."""
    m, n = dist.size.row, dist.size.col
    mb, nb = dist.block_size.row, dist.block_size.col
    nt = dist.nr_tiles
    a = t.permute(0, 2, 1, 3).reshape(nt.row * mb, nt.col * nb)
    return a[:m, :n].contiguous()
