"""Local blocked Cholesky factorization.

Port of the local branch of ``dlaf_tpu/algorithms/cholesky.py``
(``cholesky`` :1733, ``_cholesky`` :1768, ``_cholesky_local`` :99-406):
the right-looking tile algorithm — potrf on the diagonal block, panel
trsm, trailing herk/gemm update — on one device.

The JAX function is pure and copies at every ``.at[].set``; this port
updates the ONE ``(n, n)`` working tensor in place, so the input copy is
the only full-matrix buffer besides the trailing product. PyTorch runs
eagerly on one stream, so the reference's look-ahead *carry* (which frees
XLA to overlap panel k+1 with the bulk update of step k) has no dataflow
meaning here: ``lookahead`` keeps only the reference's ORDER (the next
panel column is updated before the rest) and reads everything back from
the working tensor. The factor is bitwise the same with lookahead on or
off on the "loop" and fused-step routes, where both orders compute the
same products; on the biggemm route the split products differ in shape,
which the CPU's BLAS sums in the same order (the tests pin it) but the
card's library need not.

The trailing products are ``torch.matmul`` outside any kernel, as the
reference leaves them to XLA. On a CUDA device ``cholesky`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` before it runs: a
float32 product stays in full float32.
"""

from __future__ import annotations

import torch

from .. import config
from ..common.asserts import dlaf_assert
from ..health import info as hinfo
from ..matrix.matrix import Matrix
from ..matrix.tiling import global_to_tiles, tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl
from ..tile_ops import panel_kernels as pk
from ..types import ceil_div


def _add_masked(x: torch.Tensor, upd: torch.Tensor, mask: torch.Tensor) -> None:
    """``x += where(mask, -upd, 0)`` in place — the reference's per-cell
    application (cells outside the mask get ``+0``)."""
    x.add_(torch.where(mask, -upd, 0.0))


def _add_tri(x: torch.Tensor, upd: torch.Tensor, uplo: str) -> None:
    """``x += where(tri, -upd, 0)`` in place, with ``upd`` consumed as
    scratch (no mask tensor of the trailing extent is made)."""
    upd.neg_()
    if uplo == "L":
        upd.tril_()
    else:
        upd.triu_()
    x.add_(upd)


def _loop_lower(a, panel, k1, j_from, nt, nb, n):
    """Trailing update per block column j >= j_from: herk on the diagonal
    block, one gemm below it (exact n^3/3 flops)."""
    for j in range(j_from, nt):
        j0, j1 = j * nb, min((j + 1) * nb, n)
        pj = panel[j0 - k1: j1 - k1]
        a[j0:j1, j0:j1] = tb.herk("L", "N", pj, a[j0:j1, j0:j1], alpha=-1.0)
        if j1 < n:
            a[j1:, j0:j1] = tb.gemm(panel[j1 - k1:], pj, a[j1:, j0:j1], alpha=-1.0,
                                    beta=1.0, op_b="C")


def _loop_upper(a, panel, k1, j_from, nt, nb, n):
    for j in range(j_from, nt):
        j0, j1 = j * nb, min((j + 1) * nb, n)
        pj = panel[:, j0 - k1: j1 - k1]
        a[j0:j1, j0:j1] = tb.herk("U", "C", pj, a[j0:j1, j0:j1], alpha=-1.0)
        if j1 < n:
            a[j0:j1, j1:] = tb.gemm(pj, panel[:, j1 - k1:], a[j0:j1, j1:], alpha=-1.0,
                                    beta=1.0, op_a="C")


def _cholesky_local(a: torch.Tensor, *, uplo: str, nb: int, trailing: str = "loop",
                    lookahead: bool = False, with_info: bool = False,
                    panel_fused: bool = False, step_fused: bool = False):
    """Factor the ``(n, n)`` tensor ``a`` IN PLACE in its ``uplo`` triangle
    (the other triangle passes through); returns ``a``, or ``(a, info)``
    with ``with_info``. Routes: composed (torch.linalg), ``panel_fused``
    (potrf and strip-solve kernels), ``step_fused`` (one fused step per
    strip-bearing block step)."""
    n = a.shape[0]
    nt = ceil_div(n, nb) if n else 0
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        blk = a[k0:k1, k0:k1]
        if step_fused and k1 < n:
            m = n - k1
            w = min(nb, m)
            if uplo == "L":
                diag, panel, new_col = pk.step("L", blk, a[k1:, k0:k1], a[k1:, k1:k1 + w])
                a[k0:k1, k0:k1] = diag
                a[k1:, k0:k1] = panel
                a[k1:, k1:k1 + w] = new_col
                if trailing == "loop":
                    _loop_lower(a, panel, k1, k + 2, nt, nb, n)
                elif m > w:
                    pr = panel[w:]
                    _add_tri(a[k1 + w:, k1 + w:], pr @ pr.mH, "L")
            else:
                diag, panel, new_row = pk.step("U", blk, a[k0:k1, k1:], a[k1:k1 + w, k1:])
                a[k0:k1, k0:k1] = diag
                a[k0:k1, k1:] = panel
                a[k1:k1 + w, k1:] = new_row
                if trailing == "loop":
                    _loop_upper(a, panel, k1, k + 2, nt, nb, n)
                elif m > w:
                    pr = panel[:, w:]
                    _add_tri(a[k1 + w:, k1 + w:], pr.mH @ pr, "U")
            continue
        diag = pk.potrf(uplo, blk) if panel_fused else tl.potrf(uplo, blk)
        a[k0:k1, k0:k1] = diag
        if k1 == n:
            break
        m = n - k1
        w = min(nb, m)
        if uplo == "L":
            colsrc = a[k1:, k0:k1]
            panel = (pk.panel_solve("R", "L", "C", "N", diag, colsrc) if panel_fused
                     else tb.trsm("R", "L", "C", "N", diag, colsrc))
            a[k1:, k0:k1] = panel
            if trailing == "loop":
                _loop_lower(a, panel, k1, k + 1, nt, nb, n)
            elif lookahead:
                # next panel column first, then the row-trimmed rest
                cmask = (torch.arange(m, device=a.device)[:, None]
                         >= torch.arange(w, device=a.device)[None, :])
                _add_masked(a[k1:, k1:k1 + w], panel @ panel[:w].mH, cmask)
                if m > w:
                    pr = panel[w:]
                    _add_tri(a[k1 + w:, k1 + w:], pr @ pr.mH, "L")
            else:
                _add_tri(a[k1:, k1:], panel @ panel.mH, "L")
        else:
            rowsrc = a[k0:k1, k1:]
            panel = (pk.panel_solve("L", "U", "C", "N", diag, rowsrc) if panel_fused
                     else tb.trsm("L", "U", "C", "N", diag, rowsrc))
            a[k0:k1, k1:] = panel
            if trailing == "loop":
                _loop_upper(a, panel, k1, k + 1, nt, nb, n)
            elif lookahead:
                rmask = (torch.arange(w, device=a.device)[:, None]
                         <= torch.arange(m, device=a.device)[None, :])
                _add_masked(a[k1:k1 + w, k1:], panel[:, :w].mH @ panel, rmask)
                if m > w:
                    pr = panel[:, w:]
                    _add_tri(a[k1 + w:, k1 + w:], pr.mH @ pr, "U")
            else:
                _add_tri(a[k1:, k1:], panel.mH @ panel, "U")
    return (a, hinfo.local_factor_info(a)) if with_info else a


def cholesky(uplo: str, mat: Matrix, *, donate: bool = False, with_info: bool = False):
    """Factorize the Hermitian positive-definite ``mat`` in the ``uplo``
    triangle: L L^H (uplo='L') or U^H U (uplo='U'), on ``mat``'s device.

    Returns a new Matrix whose ``uplo`` triangle holds the factor (the
    other triangle passes through), or ``(factor, info)`` with
    ``with_info``: ``info`` is an int32 device tensor, 0 on success or the
    1-based first failing column; the factor is bitwise the same either
    way. ``donate=True`` releases ``mat``'s storage to the factorization:
    ``mat`` must not be used afterwards.
    """
    dlaf_assert(uplo in ("L", "U"), f"cholesky: uplo must be 'L' or 'U', got {uplo!r}")
    dlaf_assert(mat.size.row == mat.size.col, "cholesky: matrix must be square")
    dlaf_assert(mat.block_size.row == mat.block_size.col, "cholesky: block must be square")
    dev = mat.device.type
    trailing = config.resolve("cholesky_trailing", dev)
    dlaf_assert(trailing in config.VALID_TRAILING,
                f"cholesky_trailing must be one of {config.VALID_TRAILING}, got {trailing!r}")
    nb = mat.block_size.row
    lookahead = config.resolve("cholesky_lookahead", dev) == "1"
    panel_fused = pk.panel_uses_fused(mat.dtype, nb, dev)
    step_fused = pk.step_uses_fused(mat.dtype, nb, dev)
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dist = mat.dist
    a = tiles_to_global(mat.storage, dist)
    if donate:
        mat.storage = None
    out = _cholesky_local(a, uplo=uplo, nb=nb, trailing=trailing, lookahead=lookahead,
                          with_info=with_info, panel_fused=panel_fused,
                          step_fused=step_fused)
    info = None
    if with_info:
        out, info = out
    res = Matrix(dist, global_to_tiles(out, dist))
    return (res, info) if with_info else res
