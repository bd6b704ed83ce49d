"""Row and column permutations over an index range.

Port of ``dlaf_tpu/algorithms/permutations.py`` (reference
``permutations/general/api.h:22``, the CUDA gather kernel ``perms.cu``):
``out[i] = in[perm[i]]`` along rows or columns. :func:`permute_array` is
the local gather, one ``index_select``, and the primitive of the D&C
merge's assembly. :func:`permute` permutes the element range of a tile
range of a :class:`..matrix.matrix.Matrix`: locally one gather of the
range, on a grid the reference's slot-window scheme (``:49-149``): an
all-gather along the permuted grid axis of the window of local slots that
covers the range, then a per-rank gather from it by host tables (in the
multi-process form each process for its own rank, the all-gather across
the line's processes). It is pure data movement, so the grid form equals
the local one bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert, dlaf_assert_heavy
from ..matrix.matrix import Matrix
from ..matrix.tiling import global_to_tiles, storage_tile_grid, tiles_to_global


def permute_array(coord: str, perm, arr: torch.Tensor) -> torch.Tensor:
    """``out[i] = arr[perm[i]]`` along rows (``"Row"``) or columns
    (``"Col"``) of ``arr``; ``perm`` a host array or a tensor of indices."""
    dlaf_assert(coord in ("Row", "Col"), f"bad coord {coord!r}")
    idx = torch.as_tensor(perm, dtype=torch.int64).to(arr.device)
    return arr.index_select(0 if coord == "Row" else arr.dim() - 1, idx)


def _gather_tables(nper: int, src: int, lt: int, bsz: int, a0: int, a1: int,
                   perm: np.ndarray, l0: int, w: int):
    """Per grid coordinate along the permuted axis, for each (local slot
    ``l``, intra-tile offset ``r``): the flat index into the gathered
    window ``(nper*w*bsz,)`` of the source position, and whether the
    position is inside the permuted range (reference ``:49-74``).

    Slot ``l`` on coordinate ``p`` holds global tile ``t = l*nper + (p -
    src) % nper``; tile ``t`` lives on coordinate ``(t % nper + src) %
    nper`` at slot ``t // nper``.
    """
    rp = (np.arange(nper) - src) % nper                       # (nper,)
    t = np.arange(lt)[None, :] * nper + rp[:, None]           # (nper, lt)
    g = (t[:, :, None] * bsz + np.arange(bsz)).reshape(nper, lt * bsz)
    in_range = (g >= a0) & (g < a1)
    s = np.where(in_range, perm[np.clip(g - a0, 0, max(len(perm) - 1, 0))] + a0, 0)
    ts, rs = s // bsz, s % bsz
    ps = (ts % nper + src) % nper
    ls = ts // nper - l0
    idx = np.where(in_range, ps * (w * bsz) + ls * bsz + rs, 0)
    return idx.astype(np.int64), in_range


def _rank_permute(t: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, msk: torch.Tensor,
                  coord: str) -> torch.Tensor:
    """One rank's permuted shard from its shard ``t`` ``(ltr, ltc, mb,
    nb)``, the gathered window ``g`` and its table row (the reference's
    shard_map body, ``:95-115``)."""
    ltr, ltc, mb, nb = t.shape
    if coord == "Row":
        g2 = g.permute(0, 1, 3, 2, 4).reshape(-1, ltc, nb)
        lf = t.permute(0, 2, 1, 3).reshape(ltr * mb, ltc, nb)
        new = torch.where(msk[:, None, None], g2.index_select(0, idx), lf)
        return new.reshape(ltr, mb, ltc, nb).permute(0, 2, 1, 3).contiguous()
    g2 = g.permute(0, 2, 4, 1, 3).reshape(-1, ltr, mb)
    lf = t.permute(1, 3, 0, 2).reshape(ltc * nb, ltr, mb)
    new = torch.where(msk[:, None, None], g2.index_select(0, idx), lf)
    return new.reshape(ltc, nb, ltr, mb).permute(2, 0, 3, 1).contiguous()


def permute(coord: str, perm, mat: Matrix, tile_begin: int = 0,
            tile_end: int | None = None) -> Matrix:
    """Permute rows (coord='Row') or columns ('Col') of the element range
    covered by tiles [tile_begin, tile_end), identity elsewhere; ``perm``
    indexes the range (0 is its first element). A new Matrix; ``mat`` is
    not changed. The grid form needs a host ``perm``."""
    dlaf_assert(coord in ("Row", "Col"), f"bad coord {coord!r}")
    nb = mat.block_size.row if coord == "Row" else mat.block_size.col
    ext = mat.size.row if coord == "Row" else mat.size.col
    a0 = tile_begin * nb
    a1 = ext if tile_end is None else min(tile_end * nb, ext)
    if a1 <= a0:
        return mat
    if not mat.distributed:
        g = tiles_to_global(mat.storage, mat.dist)
        idx = torch.as_tensor(perm, dtype=torch.int64).to(g.device) + a0
        if coord == "Row":
            g[a0:a1, :] = permute_array("Row", idx, g)
        else:
            g[:, a0:a1] = permute_array("Col", idx, g)
        return mat.with_storage(global_to_tiles(g, mat.dist))
    pm = np.asarray(perm)
    dlaf_assert(pm.ndim == 1 and len(pm) == a1 - a0,
                f"permute: perm length {len(pm)} != range {a1 - a0}")
    dlaf_assert_heavy(pm.min() >= 0 and pm.max() < a1 - a0,
                      "permute: perm indices outside the tile range")
    dist = mat.dist
    row = coord == "Row"
    P, Q = dist.grid_size.row, dist.grid_size.col
    nper = P if row else Q
    src = dist.source_rank.row if row else dist.source_rank.col
    _, _, ltr, ltc = storage_tile_grid(dist)
    t0, t1 = a0 // nb, -(-a1 // nb)
    l0, w = t0 // nper, (t1 - 1) // nper - t0 // nper + 1
    table, mask = _gather_tables(nper, src, ltr if row else ltc, nb, a0, a1, pm, l0, w)
    shards = mat.storage
    windows = cc.per_rank(P, Q, lambda r, c: shards[r * Q + c].narrow(0 if row else 1, l0, w))
    gathered = cc.all_gather(windows, ROW_AXIS if row else COL_AXIS, shared=True)

    def one(r, c):
        t = shards[r * Q + c]
        i = r if row else c
        return _rank_permute(t, gathered[r][c], torch.from_numpy(table[i]).to(t.device),
                             torch.from_numpy(mask[i]).to(t.device), coord)

    new = cc.per_rank(P, Q, one)
    return mat.with_storage([new[r][c] for r in range(P) for c in range(Q)])
