"""Whole-matrix structural ops: transpose, hermitianize, triangle merge,
copy and the host mirror.

Counterpart of ``dlaf_tpu/matrix/ops.py`` (reference ``matrix/copy.h``,
``MatrixMirror``). The JAX package runs each op on the global view inside
one jit and lets GSPMD move the tiles. Here each op runs per rank on the
rank's shard (one shard without a grid): the element-wise ops with the
global element indices of the shard, and the (conjugate) transpose by
copying every tile from the rank that owns its mirror: one pairwise
exchange, which in the multi-process form moves between two processes
only the tiles one holds the mirrors of.

A result never shares storage with an input the caller keeps: only
``hermitianize(..., donate=True)`` and ``merge_triangle(...,
donate_new=True)`` give an input's storage to the result, and a donated
input must not be used afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import collectives as cc
from ..common.asserts import dlaf_assert
from . import util_distribution as ud
from .matrix import Matrix
from .tiling import shard_element_indices, storage_tile_grid


def _rank_shards(mat: Matrix):
    """``[(r, c, shard)]`` of the ranks this process drives, in row-major
    rank order."""
    Q = mat.dist.grid_size.col
    storage = mat.storage if mat.distributed else [mat.storage]
    return [(i // Q, i % Q, s) for i, s in enumerate(storage) if s is not None]


def _from_shards(mat: Matrix, shards: list) -> Matrix:
    """``mat``'s layout over new local shards (those of :func:`_rank_shards`,
    in its order)."""
    if not mat.distributed:
        return mat.with_storage(shards[0])
    it = iter(shards)
    return mat.with_storage([None if s is None else next(it) for s in mat.storage])


def _element_index(mat: Matrix, r: int, c: int, device):
    """Global element row and column of every entry of rank ``(r, c)``'s
    shard, broadcastable to its ``(ltr, ltc, mb, nb)`` layout."""
    _, _, ltr, ltc = storage_tile_grid(mat.dist)
    mb, nb = mat.block_size.row, mat.block_size.col
    i, j, _, _ = shard_element_indices(mat.dist, r, c, device)
    return i.reshape(ltr, 1, mb, 1), j.reshape(1, ltc, 1, nb)


def _mirror_plan(dist, r: int, c: int) -> dict:
    """Where rank ``(r, c)``'s tiles' mirrors live: ``{(r2, c2): (li, lj,
    si, sj)}``, the local slots ``(li, lj)`` of the tiles ``(I, J)`` whose
    mirror ``(J, I)`` rank ``(r2, c2)`` holds at its slots ``(si, sj)``
    (host arrays, row-major over the local tiles)."""
    P, Q = dist.grid_size.row, dist.grid_size.col
    sr, sc = dist.source_rank.row, dist.source_rank.col
    nt = dist.nr_tiles.row
    _, _, ltr, ltc = storage_tile_grid(dist)
    gi = np.arange(ltr) * P + (r - sr) % P
    gj = np.arange(ltc) * Q + (c - sc) % Q
    li, lj = np.meshgrid(np.flatnonzero(gi < nt), np.flatnonzero(gj < nt), indexing="ij")
    li, lj = li.ravel(), lj.ravel()
    big_i, big_j = gi[li], gj[lj]
    owner_r = np.array([ud.rank_global_tile(int(J), P, sr) for J in big_j], dtype=np.int64)
    owner_c = np.array([ud.rank_global_tile(int(I), Q, sc) for I in big_i], dtype=np.int64)
    plan = {}
    for r2 in range(P):
        for c2 in range(Q):
            sel = (owner_r == r2) & (owner_c == c2)
            if sel.any():
                plan[(r2, c2)] = (li[sel], lj[sel], big_j[sel] // P, big_i[sel] // Q)
    return plan


def _transposed_shards(mat: Matrix, conj: bool) -> list:
    """The shards of ``op(A)`` (``A^H`` with ``conj``, else ``A^T``) in
    ``A``'s distribution: each tile ``(I, J)`` is tile ``(J, I)``
    transposed, fetched from the rank that owns it by one pairwise
    exchange (:func:`..comm.collectives.exchange`): each rank sends each
    other rank only the tiles whose mirrors that rank holds. The tables of
    owners and slots are host arrays every process computes alike."""
    dist = mat.dist
    P, Q = dist.grid_size.row, dist.grid_size.col
    own = _rank_shards(mat)
    if not mat.distributed:
        (_, _, shard), = own
        plan = _mirror_plan(dist, 0, 0)
        dst = torch.zeros_like(shard)
        for li, lj, si, sj in plan.values():
            tiles = shard[torch.as_tensor(si), torch.as_tensor(sj)].transpose(-1, -2)
            dst[torch.as_tensor(li), torch.as_tensor(lj)] = tiles.conj() if conj else tiles
        return [dst]
    shards = {(r, c): s for r, c, s in own}
    plans = {(r, c): _mirror_plan(dist, r, c) for r in range(P) for c in range(Q)}

    def sends(r2, c2):
        src = shards[(r2, c2)]
        return {dst: src[torch.as_tensor(p[(r2, c2)][2]), torch.as_tensor(p[(r2, c2)][3])]
                for dst, p in plans.items() if (r2, c2) in p}

    def expect(r, c):
        s = shards[(r, c)]
        return {k: s.new_empty((len(v[0]), *s.shape[2:])) for k, v in plans[(r, c)].items()}

    got = cc.exchange(cc.per_rank(P, Q, sends), cc.per_rank(P, Q, expect))
    out = []
    for r, c, shard in own:
        dst = torch.zeros_like(shard)
        for k, (li, lj, _, _) in plans[(r, c)].items():
            tiles = got[r][c][k].transpose(-1, -2)
            dst[torch.as_tensor(li), torch.as_tensor(lj)] = tiles.conj() if conj else tiles
        out.append(dst)
    return out


def transpose(mat: Matrix, conj: bool = True) -> Matrix:
    """(Conjugate-)transpose of a square matrix with square blocks, in the
    same distribution."""
    dlaf_assert(mat.size.row == mat.size.col and mat.block_size.row == mat.block_size.col,
                "transpose: square matrices only (rectangular lands later)")
    return _from_shards(mat, _transposed_shards(mat, conj))


def hermitianize(mat: Matrix, uplo: str, *, donate: bool = False) -> Matrix:
    """Full Hermitian matrix from its stored ``uplo`` triangle (the
    whole-matrix ``hermitian_from``): the strict triangle, its conjugate
    mirror and the real part of the diagonal. ``donate=True`` lets the
    result take ``mat``'s storage (``mat`` must not be used afterwards)."""
    dlaf_assert(uplo in ("L", "U"), f"hermitianize: bad uplo {uplo!r}")
    mirror = _transposed_shards(mat, conj=True)
    out = []
    for (r, c, a), t in zip(_rank_shards(mat), mirror):
        i, j = _element_index(mat, r, c, a.device)
        own = (i > j) if uplo == "L" else (i < j)
        other = (i < j) if uplo == "L" else (i > j)
        d = a.real.to(a.dtype) if a.is_complex() else a
        res = torch.where(own, a, 0.0) + torch.where(other, t, 0.0) + torch.where(i == j, d, 0.0)
        if donate:
            res = a.copy_(res)
        out.append(res)
    return _from_shards(mat, out)


def merge_triangle(new: Matrix, orig: Matrix, uplo: str, *, donate_new: bool = False,
                   donate_orig: bool = False) -> Matrix:
    """``uplo`` triangle (diagonal included) from ``new``, the opposite
    strict triangle from ``orig`` (LAPACK's in-place update at matrix
    scope), in fresh storage. ``donate_new=True`` writes the result into
    ``new``'s storage instead and ``donate_orig=True`` releases ``orig``'s;
    a donated input must not be used afterwards."""
    dlaf_assert(uplo in ("L", "U"), f"merge_triangle: bad uplo {uplo!r}")
    dlaf_assert(new.dist == orig.dist, "merge_triangle: distributions differ")
    out = []
    for (r, c, x), y in zip(_rank_shards(new), orig.shards()):
        i, j = _element_index(new, r, c, x.device)
        keep = (i >= j) if uplo == "L" else (i <= j)
        if donate_new:
            out.append(x.masked_fill_(~keep, 0.0).add_(torch.where(keep, 0.0, y)))
        else:
            out.append(torch.where(keep, x, y))
    if donate_orig:
        orig.storage = None
    return _from_shards(new, out)


def copy(mat: Matrix) -> Matrix:
    """Fresh storage with the same contents (reference ``matrix::copy``)."""
    return mat.clone()


def mirror_to_host(mat: Matrix) -> np.ndarray:
    """Device-to-host mirror (``MatrixMirror``'s host side)."""
    return mat.to_numpy()


def mirror_to_device(a: np.ndarray, like: Matrix) -> Matrix:
    """Host-to-device mirror in ``like``'s layout, grid and device."""
    return Matrix.from_global(a, like.block_size, grid=like.grid,
                              source_rank=like.dist.source_rank, device=like.device)
