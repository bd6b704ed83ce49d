"""QR T factor, local and distributed.

Port of ``dlaf_tpu/algorithms/qr.py`` (reference ``factorization/qr``,
``t_factor_impl.h``): from a panel ``V`` of ``k`` forward columnwise
Householder reflectors and their ``taus``, the compact-WY ``T`` with
``I - V T V^H`` the product of the reflectors. The closed form
``T^-1 = diag(1/tau) + strict_upper(V^H V)`` (:func:`..tile_ops.lapack.
larft`) needs only the ``k x k`` Gram matrix ``V^H V``: on a grid each
rank forms the partial Gram of its valid rows, the partial Grams are
summed along the grid's row axis (the reference's column-communicator
all-reduce), broadcast from the panel's grid column, and every rank
finishes T.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..matrix.matrix import Matrix
from ..matrix.tiling import tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl


def _partial_gram(lt: torch.Tensor, rr: int, *, P: int, m: int, k: int) -> torch.Tensor:
    """``V^H V`` over the rows of one rank's shard ``lt`` (ltr, 1, mb, nb)
    of cycle position ``rr``: unit diagonal implied, strict lower part
    kept, rows past ``m`` left out."""
    ltr, _, mb, _ = lt.shape
    dev = lt.device
    er = ((torch.arange(ltr, device=dev) * P + rr)[:, None] * mb
          + torch.arange(mb, device=dev)[None, :])[..., None]
    col = torch.arange(k, device=dev)
    tiles = lt[:, 0, :, :k]
    vv = torch.where((er > col) & (er < m), tiles, 0.0) + (er == col).to(lt.dtype)
    return tb.contract("rab,rad->bd", vv.conj(), vv)


def t_factor(v, taus) -> torch.Tensor:
    """T factor of the reflector panel ``v`` (reference
    ``computeTFactor``, local and distributed): a plain (m, k) tensor, or
    a Matrix of one block column (on one rank or a grid), unit lower
    trapezoidal with the ones implicit (its upper triangle is not read);
    ``taus`` (k,). Returns the (k, k) T, on the device of rank (0, 0) (on
    a multi-process grid: of this process's rank; every process gets the
    same T)."""
    if not isinstance(v, Matrix):
        v = torch.as_tensor(v)
        return tl.larft(v, torch.as_tensor(taus, device=v.device))
    dlaf_assert(v.dist.nr_tiles.col == 1,
                "t_factor: the reflector panel must be one block column")
    if not v.distributed:
        return tl.larft(tiles_to_global(v.storage, v.dist), torch.as_tensor(taus, device=v.device))
    dist = v.dist
    P, Q = dist.grid_size.row, dist.grid_size.col
    sr = dist.source_rank.row
    m, k = dist.size.row, dist.size.col
    shards = v.storage
    part = cc.per_rank(P, Q, lambda r, c: _partial_gram(shards[r * Q + c], (r - sr) % P, P=P,
                                                        m=m, k=k))
    gram = cc.bcast(cc.all_reduce(part, ROW_AXIS), COL_AXIS, dist.source_rank.col)
    t = cc.per_rank(P, Q, lambda r, c: tl.t_from_gram(
        gram[r][c], torch.as_tensor(taus, device=gram[r][c].device)))
    return cc.local_value(t)
