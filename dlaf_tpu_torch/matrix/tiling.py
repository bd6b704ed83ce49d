"""Layout transforms between a global matrix, tile storage and per-rank
shards.

Counterpart of ``dlaf_tpu/matrix/tiling.py``. The global tile storage has
the reference's shape ``(P*ltr, Q*ltc, mb, nb)``, its leading two axes
holding the tiles in rank-major cyclic-permuted order:

    storage[p*ltr + l_r, q*ltc + l_c] == global tile (l_r*P + (p - src_r)%P,
                                                      l_c*Q + (q - src_c)%Q)

so rank ``(p, q)``'s block-cyclic local tiles are the contiguous block
``storage[p*ltr:(p+1)*ltr, q*ltc:(q+1)*ltc]`` — its shard ``(ltr, ltc, mb,
nb)``. Edge tiles are zero-padded to full ``(mb, nb)``, and ranks that own
fewer tiles than ``ltr``/``ltc`` hold all-zero padding tiles. On the 1x1
grid the storage index of a tile is its global tile index.
"""

from __future__ import annotations

import torch

from ..types import ceil_div
from . import util_distribution as ud
from .distribution import Distribution


def storage_tile_grid(dist: Distribution) -> tuple[int, int, int, int]:
    """(P*ltr, Q*ltc, ltr, ltc): storage tile-grid extents and the uniform
    per-rank local tile counts (the most any rank owns)."""
    nt = dist.nr_tiles
    P, Q = dist.grid_size.row, dist.grid_size.col
    ltr = ceil_div(nt.row, P) if nt.row else 0
    ltc = ceil_div(nt.col, Q) if nt.col else 0
    return P * ltr, Q * ltc, ltr, ltc


def _axis_perm(n_tiles: int, grid: int, src: int, lt: int) -> list[int]:
    """Storage index -> global tile index (``n_tiles`` for a padding slot)."""
    perm = []
    for p in range(grid):
        for loc in range(lt):
            g = ud.global_tile_from_local_tile(loc, grid, p, src)
            perm.append(g if g < n_tiles else n_tiles)
    return perm


def _axis_perm_inv(n_tiles: int, grid: int, src: int, lt: int) -> list[int]:
    """Global tile index -> storage index."""
    return [ud.rank_global_tile(g, grid, src) * lt + ud.local_tile_from_global_tile(g, grid)
            for g in range(n_tiles)]


def _take(t: torch.Tensor, idx: list, dim: int) -> torch.Tensor:
    return t.index_select(dim, torch.tensor(idx, dtype=torch.int64, device=t.device))


def global_to_tiles(a: torch.Tensor, dist: Distribution) -> torch.Tensor:
    """Global ``(m, n)`` tensor -> tile storage ``(P*ltr, Q*ltc, mb, nb)``,
    on ``a``'s device."""
    m, n = dist.size.row, dist.size.col
    mb, nb = dist.block_size.row, dist.block_size.col
    nt = dist.nr_tiles
    if dist.single_rank():
        t = a.new_zeros((nt.row * mb, nt.col * nb))
        t[:m, :n] = a
        return t.reshape(nt.row, mb, nt.col, nb).permute(0, 2, 1, 3).contiguous()
    _, _, ltr, ltc = storage_tile_grid(dist)
    # one zero tile row/col past the last tile: the target of padding slots
    t = a.new_zeros(((nt.row + 1) * mb, (nt.col + 1) * nb))
    t[:m, :n] = a
    t = t.reshape(nt.row + 1, mb, nt.col + 1, nb).permute(0, 2, 1, 3)
    t = _take(t, _axis_perm(nt.row, dist.grid_size.row, dist.source_rank.row, ltr), 0)
    return _take(t, _axis_perm(nt.col, dist.grid_size.col, dist.source_rank.col, ltc), 1)


def tiles_to_global(t: torch.Tensor, dist: Distribution) -> torch.Tensor:
    """Tile storage -> a new contiguous global ``(m, n)`` tensor that
    shares no storage with ``t``: writing it never reaches the tiles."""
    m, n = dist.size.row, dist.size.col
    mb, nb = dist.block_size.row, dist.block_size.col
    nt = dist.nr_tiles
    src = t
    if not dist.single_rank():
        _, _, ltr, ltc = storage_tile_grid(dist)
        t = _take(t, _axis_perm_inv(nt.row, dist.grid_size.row, dist.source_rank.row, ltr), 0)
        t = _take(t, _axis_perm_inv(nt.col, dist.grid_size.col, dist.source_rank.col, ltc), 1)
    a = t.permute(0, 2, 1, 3).reshape(nt.row * mb, nt.col * nb)[:m, :n].contiguous()
    if a.untyped_storage().data_ptr() == src.untyped_storage().data_ptr():
        # one tile row or column (or nb = 1): the reshape needed no copy,
        # so ``a`` is a view of the tiles
        a = a.clone()
    return a


def split_shards(t: torch.Tensor, dist: Distribution, devices) -> list:
    """Tile storage -> the P*Q per-rank shards ``(ltr, ltc, mb, nb)``, in
    row-major rank order, each a new tensor on ``devices[r*Q + c]``; None
    where that entry is None (a rank another process drives)."""
    P, Q = dist.grid_size.row, dist.grid_size.col
    _, _, ltr, ltc = storage_tile_grid(dist)
    return [None if devices[r * Q + c] is None
            else t[r * ltr:(r + 1) * ltr, c * ltc:(c + 1) * ltc].to(devices[r * Q + c], copy=True)
            .contiguous() for r in range(P) for c in range(Q)]


def join_shards(shards, dist: Distribution, device) -> torch.Tensor:
    """The P*Q per-rank shards (row-major rank order) -> tile storage on
    ``device``."""
    P, Q = dist.grid_size.row, dist.grid_size.col
    rows = [torch.cat([shards[r * Q + c].to(device) for c in range(Q)], dim=1)
            for r in range(P)]
    return torch.cat(rows, dim=0)


def shard_element_indices(dist: Distribution, r: int, c: int, device):
    """Global element row and column indices of rank ``(r, c)``'s shard,
    as float64 tensors ``(ltr*mb,)`` and ``(ltc*nb,)``, and the masks of
    those inside the matrix (padding tiles and edge padding outside)."""
    mb, nb = dist.block_size.row, dist.block_size.col
    _, _, ltr, ltc = storage_tile_grid(dist)
    P, Q = dist.grid_size.row, dist.grid_size.col
    rr = (r - dist.source_rank.row) % P
    rc = (c - dist.source_rank.col) % Q
    i = ((torch.arange(ltr, device=device)[:, None] * P + rr) * mb
         + torch.arange(mb, device=device)[None, :]).reshape(-1)
    j = ((torch.arange(ltc, device=device)[:, None] * Q + rc) * nb
         + torch.arange(nb, device=device)[None, :]).reshape(-1)
    return i.double(), j.double(), i < dist.size.row, j < dist.size.col
