"""Panel exchange over the grid: per-rank index context, the diagonal
tile and panel broadcasts, and the transposed-panel exchange.

Counterpart of ``dlaf_tpu/matrix/panel.py:29-204, 297-323`` (reference
``matrix/panel.h``, ``broadcast_panel.h``). In the JAX package a
``DistContext`` holds trace-time constants and the rank's traced
coordinates inside ``shard_map``; here the controller asks it for any rank,
and every per-rank quantity (cycle position, global tile index of a local
slot) is a host int. The transposed-panel exchange is the reference's:
an all-gather along one grid axis, then an index select per rank.

The reference has two forms of the broadcasts: a static ``k`` (unrolled
builders) and a traced one (``*_dyn``, scan builders, whose slot windows
are static offsets into a telescoped view). With one controller every
``k`` is a host int, so one function serves both: :func:`col_panel` and
:func:`row_panel` take the slot window of the ``_dyn`` forms as
keywords, :func:`bcast_diag` the offsets of a telescoped view.
``gather_sub_panel_dyn`` and ``tiles_of_rolled`` (reduction to band) come
with that algorithm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from . import util_distribution as ud
from .tiling import storage_tile_grid


def uniform_slot_start(k: int, p: int) -> int:
    """Uniform local slot covering every rank's tiles >= global tile ``k``
    on a ``p``-rank axis (``floor(k / p)``; at most one slot below a
    rank's own first such slot)."""
    return max(0, -(-(k + 1 - p) // p))


def to_device(values, device, dtype=torch.int64) -> torch.Tensor:
    """A small host array as a tensor on ``device``. To a CUDA device it
    goes through pinned memory, asynchronously: the host does not wait
    for the stream to reach the copy."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class DistContext:
    """Grid extents, source ranks, local slot counts and per-rank index
    math of one distribution."""

    def __init__(self, dist):
        self.nt = dist.nr_tiles
        self.mb = dist.block_size.row
        self.P = dist.grid_size.row
        self.Q = dist.grid_size.col
        self.sr = dist.source_rank.row
        self.sc = dist.source_rank.col
        _, _, self.ltr, self.ltc = storage_tile_grid(dist)

    def rr(self, r: int) -> int:
        """Cycle position of grid row ``r``."""
        return (r - self.sr) % self.P

    def rc(self, c: int) -> int:
        return (c - self.sc) % self.Q

    def owner_r(self, k: int) -> int:
        return ud.rank_global_tile(k, self.P, self.sr)

    def owner_c(self, k: int) -> int:
        return ud.rank_global_tile(k, self.Q, self.sc)

    def kr(self, k: int) -> int:
        return ud.local_tile_from_global_tile(k, self.P)

    def kc(self, k: int) -> int:
        return ud.local_tile_from_global_tile(k, self.Q)


    def g_rows(self, r: int, lu: int, count: int) -> np.ndarray:
        """Global tile rows of grid row ``r``'s local slots lu..lu+count-1."""
        return (lu + np.arange(count)) * self.P + self.rr(r)

    def g_cols(self, c: int, lu: int, count: int) -> np.ndarray:
        return (lu + np.arange(count)) * self.Q + self.rc(c)


def bcast_diag(ctx: DistContext, lts, k: int, *, row_off: int = 0, col_off: int = 0):
    """The global diagonal tile ``(k, k)`` on every rank (one
    :func:`..comm.collectives.bcast2d`); ``lts`` per-rank shards, or their
    windows ``shard[row_off:, col_off:]``."""
    P, Q = cc.grid_shape(lts)
    kr, kc = ctx.kr(k) - row_off, ctx.kc(k) - col_off
    cand = cc.per_rank(P, Q, lambda r, c: lts[r][c][kr, kc])
    return cc.bcast2d(cand, ctx.owner_r(k), ctx.owner_c(k))


def pad_diag_identity(tile: torch.Tensor, real_size: int) -> torch.Tensor:
    """A short edge diagonal tile with its padded block replaced by the
    identity, so that factorizations and solves stay nonsingular; a full
    tile is returned as it is."""
    mb = tile.shape[-1]
    if real_size >= mb:
        return tile
    pad = torch.arange(mb, device=tile.device) >= real_size
    cleared = torch.where(pad[:, None] | pad[None, :], 0, tile)
    return cleared + torch.diag(pad.to(tile.dtype))


def col_panel(ctx: DistContext, lts, k: int, *, lu: int = 0, count=None):
    """Local-row tiles ``lu .. lu+count-1`` (default: to the end) of global
    tile column ``k``, broadcast along the column axis from its owner; per
    rank ``(count, mb, nb)``."""
    P, Q = cc.grid_shape(lts)
    kc = ctx.kc(k)

    def mine(r, c):
        lt = lts[r][c]
        end = lt.shape[0] if count is None else lu + count
        return lt[lu:end, kc]

    return cc.bcast(cc.per_rank(P, Q, mine), COL_AXIS, ctx.owner_c(k))


def row_panel(ctx: DistContext, lts, k: int, *, lu: int = 0, count=None):
    """Local-column tiles ``lu .. lu+count-1`` of global tile row ``k``,
    broadcast along the row axis from its owner (mirror of
    :func:`col_panel`)."""
    P, Q = cc.grid_shape(lts)
    kr = ctx.kr(k)

    def mine(r, c):
        lt = lts[r][c]
        end = lt.shape[1] if count is None else lu + count
        return lt[kr, lu:end]

    return cc.bcast(cc.per_rank(P, Q, mine), ROW_AXIS, ctx.owner_r(k))


def _select(full: torch.Tensor, flat: np.ndarray) -> torch.Tensor:
    return full.index_select(0, to_device(flat, full.device))


def transpose_col_to_rows(ctx: DistContext, col_tiles, lu_r: int, g_cols):
    """Transposed-panel exchange (reference ``panelT`` + transposed
    ``broadcast_panel``): from each rank's row slice of a tile COLUMN (slots
    >= ``lu_r``, already broadcast along the column axis), the panel tile
    of each of the rank's local COLUMN slots, whose global tile indices are
    ``g_cols[r][c]``. Per-rank lists in, per-rank ``(len(g_cols), mb, nb)``
    out."""
    full = cc.all_gather(col_tiles, ROW_AXIS)             # (P, nrows, mb, nb)
    P, Q = cc.grid_shape(col_tiles)

    def one(r, c):
        f = full[r][c]
        nrows = f.shape[1]
        g = g_cols[r][c]
        flat = ((ctx.sr + g) % ctx.P) * nrows + np.clip(g // ctx.P - lu_r, 0,
                                                         max(nrows - 1, 0))
        return _select(f.reshape(ctx.P * nrows, *f.shape[2:]), flat)

    return cc.per_rank(P, Q, one)


def transpose_row_to_cols(ctx: DistContext, row_tiles, lu_c: int, g_rows):
    """Mirror of :func:`transpose_col_to_rows` for a tile ROW panel."""
    full = cc.all_gather(row_tiles, COL_AXIS)             # (Q, ncols, mb, nb)
    P, Q = cc.grid_shape(row_tiles)

    def one(r, c):
        f = full[r][c]
        ncols = f.shape[1]
        g = g_rows[r][c]
        flat = ((ctx.sc + g) % ctx.Q) * ncols + np.clip(g // ctx.Q - lu_c, 0,
                                                         max(ncols - 1, 0))
        return _select(f.reshape(ctx.Q * ncols, *f.shape[2:]), flat)

    return cc.per_rank(P, Q, one)
