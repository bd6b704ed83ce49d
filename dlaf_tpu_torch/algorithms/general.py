"""General sub-matrix multiplication.

Port of ``dlaf_tpu/algorithms/general.py`` (reference
``multiplication/general``, ``GeneralSub::callNN``): ``C[r,r] = alpha
A[r,r] B[r,r] + beta C[r,r]`` over the element range ``r`` of a tile
range, one product on the range through :func:`..tile_ops.blas.mm`, so
``f64_gemm="mxu"`` takes the Ozaki product as in the reference. On a grid
the matrices are gathered on rank (0, 0)'s device, the range multiplied
there and the result scattered back to the shards. In the multi-process
form the gather and the scatter run between the processes
(:meth:`..matrix.matrix.Matrix.gather_global`, ``from_global(root=)``):
only the process of rank (0, 0) holds the global matrices, as only rank
(0, 0)'s device does under the single controller.
"""

from __future__ import annotations

import torch

from ..common.asserts import dlaf_assert
from ..common.index2d import RankIndex2D
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
    nb = a.block_size.row
    a0 = tile_begin * nb
    a1 = min(tile_end * nb, a.size.row)
    root = RankIndex2D(0, 0)
    # the global matrices on rank (0, 0)'s device (its process only)
    gc = c.gather_global(root)
    if a1 > a0:
        ga, gb = a.gather_global(root), b.gather_global(root)
        if gc is not None:
            sl = slice(a0, a1)
            prod = tb.mm(ga[sl, sl], gb[sl, sl])
            del ga, gb
            alpha = torch.as_tensor(alpha, dtype=gc.dtype, device=gc.device)
            beta = torch.as_tensor(beta, dtype=gc.dtype, device=gc.device)
            gc[sl, sl] = alpha * prod + beta * gc[sl, sl]
    if not c.distributed:
        return c.with_storage(global_to_tiles(gc, c.dist))
    if c.grid.multi_process:
        return Matrix.from_global(gc, c.block_size, c.grid, source_rank=c.dist.source_rank,
                                  root=root, size=c.size, dtype=c.dtype)
    return c.with_storage(split_shards(global_to_tiles(gc, c.dist), c.dist, c.grid.devices))
