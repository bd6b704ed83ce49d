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
Reduction to band's sub-panel helpers (``dlaf_tpu/matrix/panel.py:125-168,
220-294``) follow: the ordered gather of a panel column, the width-``b``
sub-panel gather at a static or a telescoped offset, and its alignment
back to tile rows. Their element masks are numpy arrays per grid row or
column (:func:`element_valid`). The gathered panel is the same on every
rank and only read, so it is formed once per device
(``shared=True`` receivers, ``cc.per_rank_once``).

Every function here builds its per-rank values with ``cc.per_rank``, so
in the multi-process form (:mod:`..comm.multihost`) it computes the local
rank's only and its collectives run across the processes; that holds for
the sub-panel helpers of reduction to band too, whose non-owners pass a
placeholder of the owner's shape and dtype to the broadcast
(:func:`_owner_masked`).
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
        self.dist = dist
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

    def row_start(self, k: int) -> int:
        """Uniform local row slot covering every rank's tiles >= ``k``."""
        return uniform_slot_start(k, self.P)

    def col_start(self, k: int) -> int:
        return uniform_slot_start(k, self.Q)

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


# ---------------------------------------------------------------------------
# Reduction to band's sub-panels (reference panel.py:125-168, 220-294)
# ---------------------------------------------------------------------------

def element_valid(g: np.ndarray, nb: int, lo: int, hi: int) -> np.ndarray:
    """``(len(g), nb)`` mask of the elements of tile slots with global tile
    indices ``g`` whose global element index lies in ``[lo, hi)``."""
    e = g[:, None] * nb + np.arange(nb)[None, :]
    return (e >= lo) & (e < hi)


def gather_col_panel_ordered(ctx: DistContext, col_tiles, k1: int, lu: int):
    """Every panel tile (global tile rows ``k1 .. nt-1``, in global order)
    on every rank: the per-rank row slices (slots ``lu ..`` covering rows
    >= ``k1``, already broadcast along the column axis) all-gathered along
    the row axis and put in order by one static index select. Per rank
    ``(nt - k1, mb, ...)``, the same on every rank: formed once per device
    and only read."""
    nt = ctx.nt.row
    nrows = cc.local_value(col_tiles).shape[0]
    order = np.array([((ctx.sr + g) % ctx.P) * nrows + (g // ctx.P - lu)
                      for g in range(k1, nt)], dtype=np.int64)
    full = cc.all_gather(col_tiles, ROW_AXIS, shared=True)   # (P, nrows, mb, ...)
    P, Q = cc.grid_shape(col_tiles)

    def one(r, c):
        f = full[r][c]
        return f.reshape(ctx.P * nrows, *f.shape[2:]).index_select(0, to_device(order, f.device))

    return cc.per_rank_once(P, Q, lambda r, c: full[r][c].device, one)


def _owner_masked(ctx, lts, owner_c: int, piece, mask):
    """Per rank: ``where(mask, piece(r, c), 0)`` on the ranks of grid
    column ``owner_c`` (the only values a broadcast from it reads), and
    elsewhere a placeholder on the rank's device: empty under the single
    controller; in the multi-process form, where every process of a line
    passes the source's shape and dtype, an uninitialized tensor of that
    shape and dtype, which the broadcast overwrites."""
    P, Q = cc.grid_shape(lts)

    def one(r, c):
        if c != owner_c:
            if cc.world() is None:   # the single controller's broadcast reads the owner's only
                return lts[r][c].new_empty(0)
            return torch.empty_like(piece(r, c), memory_format=torch.contiguous_format)
        x = piece(r, c)
        return torch.where(mask(r, x.device)[..., None], x, 0.0)

    return cc.per_rank(P, Q, one)


def gather_sub_panel(ctx: DistContext, lts, *, pb: int, b: int, n: int):
    """Gather the width-``b`` reflector sub-panel at element columns
    ``[pb, pb+b)`` acting below the boundary row ``pb+b``, replicated on
    every rank: its tile column's slice at the static in-tile offset, rows
    above the boundary masked, broadcast along the column axis, tile rows
    gathered in global order (read only: ranks on one device share it).
    Returns ``None`` when no rank has a row slot below the boundary, else
    ``(pan, lu, tr0, ro, row_val_e, g_rows)``:
    ``pan[r][c]`` the ``(m_full - ro, b)`` panel from the boundary row on,
    ``lu`` its first local row slot, ``tr0``/``ro`` the boundary's tile row
    and in-tile row, and per grid row ``r`` the element mask
    ``row_val_e[r]`` ``(nrows, nb)`` and global tile rows ``g_rows[r]`` of
    the slots ``lu ..``."""
    from ..common.index2d import GlobalElementIndex
    from .views import SubMatrixView, SubPanelView

    nb, nt = ctx.mb, ctx.nt.row
    bdy = pb + b
    pan_view = SubPanelView(ctx.dist, GlobalElementIndex(pb, pb), width=b)
    body = SubMatrixView(ctx.dist, GlobalElementIndex(bdy, pb))
    tc, co = pan_view.begin_tile.col, pan_view.origin_in_tile.col
    tr0, ro = body.begin_tile.row, body.origin_in_tile.row
    lu = ctx.row_start(tr0)
    nrows = ctx.ltr - lu
    if nrows <= 0:
        return None
    g_rows = [ctx.g_rows(r, lu, nrows) for r in range(ctx.P)]
    row_val_e = [element_valid(g, nb, bdy, n) for g in g_rows]
    kc = ctx.kc(tc)
    mine = _owner_masked(ctx, lts, ctx.owner_c(tc),
                         lambda r, c: lts[r][c][lu:, kc, :, co:co + b],
                         lambda r, dev: to_device(row_val_e[r], dev, torch.bool))
    mine = cc.bcast(mine, COL_AXIS, ctx.owner_c(tc), shared=True)
    ptiles = gather_col_panel_ordered(ctx, mine, tr0, lu)
    P, Q = cc.grid_shape(lts)
    pan = cc.per_rank(P, Q, lambda r, c: ptiles[r][c].reshape((nt - tr0) * nb, b)[ro:])
    return pan, lu, tr0, ro, row_val_e, g_rows


def pad_sub_panel_to_tiles(ctx: DistContext, mat: torch.Tensor, *, tr0: int, ro: int):
    """Align an ``(m_full - ro, b)`` sub-panel to tile rows: zero rows for
    the ``ro`` rows above the boundary (masked out by every caller), cut
    into ``(nt - tr0, mb, b)`` tiles."""
    b = mat.shape[1]
    return torch.cat([mat.new_zeros((ro, b)), mat]).reshape(ctx.nt.row - tr0, ctx.mb, b)


def gather_sub_panel_dyn(ctx: DistContext, lts, *, p: int, b: int, n: int,
                         row_off: int = 0, col_off: int = 0):
    """:func:`gather_sub_panel` at the uniform shapes of the scan form:
    the window-height masked panel column gathered in global order and
    top-aligned by a roll (zero rows below a Householder panel leave its
    reflectors unchanged, so geqrf of the rolled ``(nt_w*mb, b)`` column is
    the shrunken panel's, zero-padded). ``lts`` are the telescoped windows
    ``shard[row_off:, col_off:]``: the gather covers global tile rows
    ``[row_off*P, nt)`` and the roll is relative to the window's first
    element row. Returns ``(pan, bdy, tc, co, row_val_e, g_rows, raw)``:
    ``row_val_e[r]``/``g_rows[r]`` over the window's row slots, ``raw[r][c]``
    the unmasked local slice of the panel column (for the write-back)."""
    nb, nt = ctx.mb, ctx.nt.row
    base = row_off * ctx.P          # first global tile row of the window
    bdy = (p + 1) * b
    tc, co = (p * b) // nb, (p * b) % nb
    count = ctx.ltr - row_off
    g_rows = [ctx.g_rows(r, row_off, count) for r in range(ctx.P)]
    row_val_e = [element_valid(g, nb, bdy, n) for g in g_rows]
    kc = ctx.kc(tc) - col_off
    P, Q = cc.grid_shape(lts)
    raw = cc.per_rank(P, Q, lambda r, c: lts[r][c][:, kc, :, co:co + b])
    mine = _owner_masked(ctx, lts, ctx.owner_c(tc), lambda r, c: raw[r][c],
                         lambda r, dev: to_device(row_val_e[r], dev, torch.bool))
    mine = cc.bcast(mine, COL_AXIS, ctx.owner_c(tc), shared=True)
    ptiles = gather_col_panel_ordered(ctx, mine, base, row_off)
    pan = cc.per_rank(P, Q, lambda r, c: torch.roll(
        ptiles[r][c].reshape((nt - base) * nb, b), -(bdy - base * nb), 0))
    return pan, bdy, tc, co, row_val_e, g_rows, raw


def tiles_of_rolled(ctx: DistContext, mat: torch.Tensor, bdy: int, base_el: int = 0):
    """Roll a top-aligned sub-panel quantity back to matrix row space and
    cut it into ``(rows/mb, mb, b)`` tiles (the scan form's
    :func:`pad_sub_panel_to_tiles`); ``base_el`` is the first element row of
    the telescoped window it lives in."""
    return torch.roll(mat, bdy - base_el, 0).reshape(mat.shape[0] // ctx.mb, ctx.mb,
                                                     mat.shape[1])
