"""Standard and generalized Hermitian eigensolvers.

Port of ``dlaf_tpu/eigensolver/eigensolver.py:39-333`` (reference
``eigensolver/eigensolver``, ``impl.h:33-78``, and ``gen_eigensolver``,
``impl.h:24-35``), local and on a grid:

    hermitianize -> reduction_to_band -> extract_band -> band_to_tridiag
    (host chase) -> tridiag_solver (D&C) -> bt_band_to_tridiag
    -> bt_reduction_to_band

and for ``A x = lambda B x``: cholesky(B) -> gen_to_std -> eigensolver ->
the triangular back-substitution of the eigenvectors.

On a grid the reduction and both back-transforms run distributed; the
band crosses to the host for the chase, and the D&C's Q, formed on rank
(0, 0)'s device, is re-tiled onto the grid with ``Matrix.from_global``, as
the reference does. In the multi-process form (one process per rank,
:mod:`..comm.multihost`) the band's tiles are gathered on the process of
rank (0, 0), which alone runs the chase and the D&C, as the single
controller runs them once on rank (0, 0)'s device; the chase's arrays
reach the other processes by the transport's broadcast, the eigenvalues
as a small object, and Q by one scatter of shards
(``from_global(root=)``). The other processes wait in that broadcast:
they hold no ``n x n`` tensor from the band's gather to Q's scatter. Every process returns the same eigenvalues, and stage
walls are this process's (the miniapps print process 0's).

Records (:mod:`..obs`): the ``eigensolver`` and ``gen_eigensolver`` entry
spans with the reference's flop model and attrs (``eigensolver.py:112,
301``; ``dc_level_batch`` and ``bt_lookahead`` are 0, the knobs the port
dropped), around the ``stage.*`` phase spans of the PhaseTimer.

Not ported now: ``resume`` and the stage checkpoints (with the health and
checkpoint port: ``resume=True`` raises rather than recompute silently),
and the autotune steering.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..algorithms.cholesky import cholesky
from ..algorithms.gen_to_std import gen_to_std
from ..algorithms.triangular import triangular_solve
from ..comm import multihost
from ..common.asserts import dlaf_assert
from ..common.index2d import RankIndex2D
from ..common.sync import hard_fence
from ..common.timer import PhaseTimer
from ..matrix import ops as mops
from ..matrix.matrix import Matrix
from ..types import dtype_name, total_ops
from .back_transform import bt_band_to_tridiag, bt_reduction_to_band
from .band_to_tridiag import band_to_tridiag, share_tridiag
from .reduction_to_band import extract_band, reduction_to_band
from .tridiag_solver import tridiag_solver


@dataclasses.dataclass
class EigensolverResult:
    """Reference ``EigensolverResult{eigenvalues, eigenvectors}``."""

    eigenvalues: np.ndarray   # (n,) real, ascending
    eigenvectors: Matrix      # columns are eigenvectors


def _fences(phases):
    """(fence of a Matrix, fence of a tensor): device fences when stage
    walls are wanted, else nothing."""
    if phases is None:
        return (lambda m: None), (lambda t: None)
    return (lambda m: hard_fence(*m.shards())), hard_fence


def eigensolver(uplo: str, a: Matrix, phases: Optional[PhaseTimer] = None,
                band_size: int | None = None, *, donate: bool = False, resume: bool = False,
                keep: Optional[dict] = None) -> EigensolverResult:
    """Eigenvalues and eigenvectors of the Hermitian ``a`` stored in its
    ``uplo`` triangle (reference ``eigensolver::eigensolver``), on ``a``'s
    device(s); the eigenvectors in ``a``'s layout.

    ``phases`` collects each stage's wall (``stage.<name>``); each stage
    then ends with a device fence. ``band_size`` (default: the block size)
    must divide the block size. ``donate=True`` releases ``a``'s storage
    to the first stage (``a`` must not be used afterwards); with
    ``donate=False`` it is left as it was. ``keep``, a dict, receives the
    stages' intermediate results: ``"reduction"`` (the band reduction),
    ``"tridiag"`` (the chase's result) and ``"dc_stats"`` (the D&C's
    per-merge statistics)."""
    dlaf_assert(not resume, "eigensolver: resume=True needs the stage checkpoints, which "
                            "are not ported yet")
    dlaf_assert(a.size.row == a.size.col, "eigensolver: square only")
    n = a.size.row
    if n == 0:
        return EigensolverResult(np.zeros(0), a)
    span = obs.entry_span("eigensolver", lambda: dict(
        flops=total_ops(a.dtype, 5 * n ** 3 / 3, 5 * n ** 3 / 3), n=n, nb=a.block_size.row,
        uplo=uplo, dtype=dtype_name(a.dtype), dc_level_batch=0, bt_lookahead=0,
        grid=f"{a.dist.grid_size.row}x{a.dist.grid_size.col}"))
    with span:
        return _eigensolver(uplo, a, phases, band_size, donate, keep)


def _eigensolver(uplo, a, phases, band_size, donate, keep):
    n = a.size.row
    pt = phases if phases is not None else PhaseTimer()
    fence, fence_t = _fences(phases)
    dc_stats = [] if keep is not None else None
    with pt.phase("stage.reduction_to_band"):
        # hermitianize gives a fresh matrix owned here, donated onward
        ah = mops.hermitianize(a, uplo, donate=donate)
        red = reduction_to_band(ah, band_size=band_size, donate=True)
        fence(red.matrix)
    mp = a.distributed and a.grid.multi_process
    with pt.phase("stage.band_to_tridiag"):
        # in the multi-process form the band reaches rank (0, 0)'s process
        # only (None elsewhere), and only that process chases it
        band = extract_band(red)
        tri = None if band is None else band_to_tridiag(band, red.band)
        del band
    with pt.phase("stage.tridiag_solver"):
        lam = z = None
        if tri is not None:
            lam, z = tridiag_solver(tri.d, tri.e, a.block_size.row, device=a.device,
                                    stats=dc_stats)
            fence_t(z)
        if mp:
            # the other processes wait here: the chase's result crosses
            # as arrays, the eigenvalues and the merge statistics (O(n))
            # as one small object
            owner = tri is not None
            tri = share_tridiag(tri, a.grid)
            lam, got = multihost.broadcast_object((lam, dc_stats) if owner else None,
                                                  src=a.grid.process_rank(0, 0))
            if dc_stats is not None and not owner:
                dc_stats.extend(got)
    with pt.phase("stage.bt_band_to_tridiag"):
        if a.distributed:
            # Q crosses from rank (0, 0)'s process by one scatter of shards
            zb = bt_band_to_tridiag(tri, Matrix.from_global(
                z, a.block_size, grid=a.grid, source_rank=a.dist.source_rank,
                root=RankIndex2D(0, 0), size=a.size, dtype=torch.float64))
            del z
            fence(zb)
        else:
            zb = bt_band_to_tridiag(tri, z)
            del z
            fence_t(zb)
    with pt.phase("stage.bt_reduction_to_band"):
        out = bt_reduction_to_band(red, zb)
        del zb
        vecs = out if a.distributed else Matrix.from_global(
            out, a.block_size, grid=a.grid, source_rank=a.dist.source_rank, device=a.device)
        fence(vecs)
    if keep is not None:
        keep.update(reduction=red, tridiag=tri, dc_stats=dc_stats)
    return EigensolverResult(lam, vecs)


def gen_eigensolver(uplo: str, a: Matrix, b: Matrix, phases: Optional[PhaseTimer] = None,
                    band_size: int | None = None, *, donate: bool = False,
                    keep: Optional[dict] = None) -> EigensolverResult:
    """The generalized problem ``A x = lambda B x`` with Hermitian ``a``
    and HPD ``b``, both stored in ``uplo`` (reference
    ``eigensolver::genEigensolver``). ``donate=True`` releases ``a``'s
    storage; ``b`` is never consumed. ``phases`` and ``keep`` as in
    :func:`eigensolver`."""
    dlaf_assert(a.size == b.size, "gen_eigensolver: A/B size mismatch")
    span = obs.entry_span("gen_eigensolver", lambda: dict(
        n=a.size.row, nb=a.block_size.row, uplo=uplo, dtype=dtype_name(a.dtype),
        grid=f"{a.dist.grid_size.row}x{a.dist.grid_size.col}"))
    with span:
        return _gen_eigensolver(uplo, a, b, phases, band_size, donate, keep)


def _gen_eigensolver(uplo, a, b, phases, band_size, donate, keep):
    pt = phases if phases is not None else PhaseTimer()
    fence, _ = _fences(phases)
    with pt.phase("stage.cholesky"):
        bf = cholesky(uplo, b)
        fence(bf)
    with pt.phase("stage.gen_to_std"):
        astd = gen_to_std(uplo, a, bf, donate=donate)
        fence(astd)
    res = eigensolver(uplo, astd, phases=phases, band_size=band_size, donate=True, keep=keep)
    # uplo L: B = L L^H, x = L^-H y; uplo U: B = U^H U, x = U^-1 y
    with pt.phase("stage.back_substitution"):
        op = "C" if uplo == "L" else "N"
        vecs = triangular_solve("L", uplo, op, "N", 1.0, bf, res.eigenvectors, donate_b=True)
        fence(vecs)
    return EigensolverResult(res.eigenvalues, vecs)
