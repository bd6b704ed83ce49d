"""Pieces of a distributed step shared by the Cholesky and HEGST
builders: the tile-pair mode table of a rank's bulk update, the slot
range of a trailing window, the masked in-place subtracts, and the
product of the Ozaki route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tile_ops import blas as tb
from ..tile_ops import ozaki as oz

__all__ = ["oz_product", "pair_modes", "sub_masked_pairs", "sub_masked_rows", "valid_range"]


def oz_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` on the Ozaki route (complex: the 4-real-product form), the
    lookahead split's strip on the same route as the bulk it was split
    from."""
    mm = oz.matmul_c128 if x.is_complex() else oz.matmul_f64
    return mm(x, y, slices=tb._oz_slices())


def valid_range(g: np.ndarray, k: int, nt: int) -> tuple[int, int]:
    """[a, b): the slots whose (increasing) global tile index lies in
    (k, nt) — the reference's ``(g > k) & (g < nt)`` mask as a range."""
    a = int(np.searchsorted(g, k, side="right"))
    return a, max(a, int(np.searchsorted(g, nt, side="left")))


def pair_modes(g_rows, g_cols, k, nt, uplo, stripped):
    """The bulk update's (R, C) mode table of one rank: 1 a tile pair
    strictly inside the trailing triangle, 2 (uplo 'L') / 3 ('U') a
    diagonal tile, 0 elsewhere; ``stripped`` leaves out the column (row)
    k+1 that the look-ahead strip updated."""
    rv = (g_rows > k) & (g_rows < nt)
    cv = (g_cols > k) & (g_cols < nt)
    pair = rv[:, None] & cv[None, :]
    ondiag = pair & (g_rows[:, None] == g_cols[None, :])
    if uplo == "L":
        off = pair & (g_rows[:, None] > g_cols[None, :])
        if stripped:
            keep = (g_cols != k + 1)[None, :]
            off, ondiag = off & keep, ondiag & keep
        return off.astype(np.int32) + 2 * ondiag.astype(np.int32)
    off = pair & (g_rows[:, None] < g_cols[None, :])
    if stripped:
        keep = (g_rows != k + 1)[:, None]
        off, ondiag = off & keep, ondiag & keep
    return off.astype(np.int32) + 3 * ondiag.astype(np.int32)


def sub_masked_pairs(block, upd, mode, uplo):
    """``block -= where(mask, upd, 0)`` in place: the whole tile where the
    mode is 1, its ``uplo`` triangle where it is 2 or 3."""
    mb = block.shape[-1]
    i = torch.arange(mb, device=block.device)
    tri = (i[:, None] >= i[None, :]) if uplo == "L" else (i[:, None] <= i[None, :])
    m = mode[:, :, None, None]
    block.sub_(torch.where((m == 1) | ((m > 1) & tri), upd, 0.0))


def sub_masked_rows(col, upd, full, diag_slot, lower):
    """The look-ahead strip's masked subtract, in place: ``upd`` wholly on
    the slots ``full`` = [a, b), its lower (``lower``) or upper triangle on
    ``diag_slot``."""
    a, b = full
    if b > a:
        col[a:b].sub_(upd[a:b])
    if diag_slot is not None:
        tri = torch.tril if lower else torch.triu
        col[diag_slot].sub_(tri(upd[diag_slot]))
