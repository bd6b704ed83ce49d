"""General sub-matrix multiplication.

Port of ``dlaf_tpu/algorithms/general.py`` (reference
``multiplication/general``, ``GeneralSub::callNN``): ``C[r,r] = alpha
A[r,r] B[r,r] + beta C[r,r]`` over the element range ``r`` of a tile
range, one product on the range through :func:`..tile_ops.blas.mm`, so
``f64_gemm="mxu"`` takes the Ozaki product as in the reference. On a grid
the range is gathered, multiplied and scattered back to the shards.
"""

from __future__ import annotations

import torch

from ..comm.grid import refuse_multi_process
from ..common.asserts import dlaf_assert
from ..matrix.matrix import Matrix
from ..matrix.tiling import global_to_tiles, split_shards
from ..tile_ops import blas as tb


def general_sub_multiply(alpha, a: Matrix, b: Matrix, beta, c: Matrix,
                         tile_begin: int, tile_end: int) -> Matrix:
    """``C[r,r] = alpha A[r,r] B[r,r] + beta C[r,r]`` with ``r`` the
    element range covered by tiles [tile_begin, tile_end); a new Matrix,
    ``c`` is not changed."""
    dlaf_assert(a.block_size == b.block_size == c.block_size,
                "general_sub_multiply: block sizes must agree")
    refuse_multi_process(c.grid, "general_sub_multiply",
                         "the multi-process general_sub_multiply")
    nb = a.block_size.row
    a0 = tile_begin * nb
    a1 = min(tile_end * nb, a.size.row)
    gc = c.to_global()
    if a1 > a0:
        sl = slice(a0, a1)
        prod = tb.mm(a.to_global()[sl, sl], b.to_global()[sl, sl])
        alpha = torch.as_tensor(alpha, dtype=gc.dtype, device=gc.device)
        beta = torch.as_tensor(beta, dtype=gc.dtype, device=gc.device)
        gc[sl, sl] = alpha * prod + beta * gc[sl, sl]
    tiles = global_to_tiles(gc, c.dist)
    if not c.distributed:
        return c.with_storage(tiles)
    return c.with_storage(split_shards(tiles, c.dist, c.grid.devices))
