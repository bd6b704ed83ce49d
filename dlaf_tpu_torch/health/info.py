"""Failure detection: info values from factor diagonals.

Counterpart of ``dlaf_tpu/health/info.py:31-146``. A failed Cholesky leaves
NaN from its first failing column on, and NaN propagates through every
later trailing update, so the FIRST non-finite diagonal entry of the final
factor is the blocked algorithm's info: the 1-based first failing global
column, 0 on success. Computed on the device, with no host sync. On a
grid each rank reads only the diagonal tiles it owns
(:func:`dist_diag_bad`), and the distributed Cholesky merges the per-rank
vectors with an all-reduce max over both grid axes. The triangular solve
reads its info from the stored diagonal of ``A``
(:func:`matrix_diag_info`; on a multi-process grid by the same owner-masked
merge), a program telemetry site ``diag_info`` (:mod:`..obs.telemetry`).
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS


def bad_diag_mask(d: torch.Tensor, *, singular: bool = False) -> torch.Tensor:
    """Bool mask of "bad" diagonal entries: non-finite real part;
    ``singular=True`` also flags exact zeros and, for complex, a
    non-finite imaginary part."""
    if d.is_complex():
        bad = ~torch.isfinite(d.real)
        if singular:
            bad = bad | ~torch.isfinite(d.imag) | (d == 0)
    else:
        bad = ~torch.isfinite(d)
        if singular:
            bad = bad | (d == 0)
    return bad


def first_bad_info(bad: torch.Tensor) -> torch.Tensor:
    """1-based index of the first True along the last axis, 0 if none,
    as an int32 tensor on ``bad``'s device."""
    if bad.shape[-1] == 0:
        return torch.zeros(bad.shape[:-1], dtype=torch.int32, device=bad.device)
    idx = torch.argmax(bad.to(torch.int8), dim=-1)
    return torch.where(bad.any(dim=-1), idx + 1, 0).to(torch.int32)


def local_factor_info(a: torch.Tensor, *, singular: bool = False) -> torch.Tensor:
    """Info of a square global factor: 1-based first bad diagonal column."""
    if a.shape[-1] == 0:
        return torch.zeros((), dtype=torch.int32, device=a.device)
    return first_bad_info(bad_diag_mask(torch.diagonal(a, dim1=-2, dim2=-1),
                                        singular=singular))


def dist_diag_bad(lt: torch.Tensor, rr: int, rc: int, *, Pr: int, Qc: int, nt: int, mb: int,
                  n: int, singular: bool = False) -> torch.Tensor:
    """Per-rank owner-masked bad-column vector: ``lt`` is the rank's shard
    ``(ltr, ltc, mb, mb)``, ``rr``/``rc`` its cycle positions. A length-``n``
    int32 vector, 1 exactly at the global diagonal columns of the diagonal
    tiles this rank owns whose entry is bad, 0 elsewhere; owner sets are
    disjoint, so a max over all ranks is the global vector."""
    vec = torch.zeros((nt * mb,), dtype=torch.int32, device=lt.device)
    ltr, ltc = lt.shape[0], lt.shape[1]
    for lr in range(ltr):
        g = lr * Pr + rr
        if g >= nt or (g - rc) % Qc:
            continue
        lc = (g - rc) // Qc
        if 0 <= lc < ltc:
            bad = bad_diag_mask(torch.diagonal(lt[lr, lc]), singular=singular)
            vec[g * mb:(g + 1) * mb] = bad.to(torch.int32)
    return vec[:n]


def _diag_tile_coords(dist):
    """Per global diagonal tile, in global order: ``(rank row, rank col,
    local slot row, local slot col, extent)`` (the reference's storage
    coordinates, as the port's per-rank shards address them)."""
    from ..matrix import util_distribution as ud

    mb, n = dist.block_size.row, dist.size.row
    P, Q = dist.grid_size.row, dist.grid_size.col
    sr, sc = dist.source_rank.row, dist.source_rank.col
    return [(ud.rank_global_tile(k, P, sr), ud.rank_global_tile(k, Q, sc),
             ud.local_tile_from_global_tile(k, P), ud.local_tile_from_global_tile(k, Q),
             min(mb, n - k * mb)) for k in range(dist.nr_tiles.row)]


def matrix_diag_info(mat, *, singular: bool = False) -> torch.Tensor:
    """1-based first bad global diagonal column of ``mat`` (0 = clean), an
    int32 tensor on the device of rank (0, 0), with no host sync.
    ``singular=True`` is the triangular solve's detection (a zero or
    non-finite diagonal entry); the default matches ``potrf_info``
    (non-finite only)."""
    from .. import obs

    return obs.telemetry.call("diag_info", _diag_info_program, mat.storage, mat.dist,
                              mat.grid, singular=singular)


def _diag_info_program(storage, dist, grid, *, singular: bool) -> torch.Tensor:
    from ..matrix.matrix import Matrix

    mat = Matrix(dist, storage, grid)
    coords = _diag_tile_coords(mat.dist)
    if not coords:
        return torch.zeros((), dtype=torch.int32, device=mat.device)
    Q = mat.dist.grid_size.col
    if mat.distributed and mat.grid.multi_process:
        # each process reads the diagonal tiles its rank owns; the owner-
        # masked vectors merge by an all-reduce max over both grid axes
        d = mat.dist
        P, nt, mb, n = d.grid_size.row, d.nr_tiles.row, d.block_size.row, d.size.row
        vec = cc.per_rank(P, Q, lambda r, c: dist_diag_bad(
            mat.storage[r * Q + c], (r - d.source_rank.row) % P, (c - d.source_rank.col) % Q,
            Pr=P, Qc=Q, nt=nt, mb=mb, n=n, singular=singular))
        vec = cc.all_reduce(cc.all_reduce(vec, ROW_AXIS, "max"), COL_AXIS, "max")
        return first_bad_info(cc.local_value(vec) > 0)
    shards = mat.shards()
    d = torch.cat([torch.diagonal(shards[r * Q + c][lr, lc])[:ts].to(mat.device)
                   for r, c, lr, lc, ts in coords])
    return first_bad_info(bad_diag_mask(d, singular=singular))
