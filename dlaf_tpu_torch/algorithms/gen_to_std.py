"""Generalized-to-standard eigenproblem transform (HEGST), local and
distributed.

Port of ``dlaf_tpu/algorithms/gen_to_std.py`` (reference
``eigensolver/gen_to_std``): given the Cholesky factor of B, transform
``A x = lambda B x`` to standard form,

    uplo='L':  A <- inv(L) A inv(L)^H        (B = L L^H)
    uplo='U':  A <- inv(U^H) A inv(U)        (B = U^H U).

Two formulations (knob ``hegst_impl``):

* ``"blocked"``: per step k, the deferred trailing solve of every previous
  panel (row k solved with the diagonal tile of the factor, one product
  fans it into the rows below: the reference's reshuffled "huge TRSM"),
  the two-sided transform of the diagonal tile, the panel solve with two
  half-weight hemms around the her2k trailing update. Local
  (:func:`_hegst_local`, in place on one global tensor, as
  ``_cholesky_local``) and distributed (:func:`_hegst_dist`, one
  controller running every rank, or one process per rank, as
  ``_cholesky_dist``).
* ``"twosolve"``: hermitianize A, then two whole triangular solves
  (:func:`..algorithms.triangular.triangular_solve`): about twice the
  operations, no per-step panel chain. The scan step mode
  (``dist_step_mode``) always takes it, as in the reference.

The diagonal tile's solves and the panel solve go through the strip-solve
kernel (#2) under ``panel_impl=fused`` (float32/bfloat16), else through
``blas.trsm_panel``, which follows ``f64_trsm`` with one refined inverse
of the diagonal tile per step. The distributed pair and strip products
follow ``f64_gemm`` onto the Ozaki products (kernel #6 on the card; a
complex product is four real ones), the local form's through
``blas.gemm``/``her2k``. ``b_factor`` is never written; ``a`` is, only
with ``donate=True``.

PyTorch runs eagerly, so ``lookahead`` (``cholesky_lookahead``) keeps the
reference's ORDER only: the next column (row) of the her2k first, read
back from the working tensor at the next step. ``comm_lookahead`` runs
step k+1's panel chain before step k's bulk, which does not write what
the chain reads: the result is bitwise the same with it on or off. The
distributed strip is a column (row) block of the bulk's pair product, so
``lookahead`` is bitwise there wherever the library sums a block of a
product as the whole product (the CPU's BLAS; the tests pin it); the
local form's rest of the her2k is a row-trimmed product of its own, as
in the reference, and agrees to rounding.

Records (:mod:`..obs`): the ``gen_to_std`` entry span with the
reference's flop model and attrs (``gen_to_std.py:831``); on a grid the
blocked form's per-step ``hegst.step<k>.panel|strip|bulk`` phases and
``dlaf_comm_overlapped_total`` of the chain hoisted by
``comm_lookahead``; the program telemetry sites ``gen_to_std.local`` and
``gen_to_std.dist`` of the blocked forms (:mod:`..obs.telemetry`).

Under ``DLAF_AUTOTUNE`` (:mod:`..autotune`) ``gen_to_std`` runs under its
site's route (op ``hegst``) and, when ``a`` survives (``donate=False``),
feeds the transform's Hutchinson residual back (the reference's
``gen_to_std.py:750-837``). The twosolve form takes its routes through
the triangular solver's own ``trsm`` steering; its probe still reports
at ``hegst``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config, obs
from ..autotune import routes as at_routes
from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..health import info as hinfo
from ..matrix import ops as mops
from ..matrix.distribution import assert_slot_aligned
from ..matrix.matrix import Matrix
from ..matrix.panel import (DistContext, bcast_diag, col_panel, pad_diag_identity, row_panel,
                            to_device, transpose_col_to_rows, transpose_row_to_cols,
                            uniform_slot_start)
from ..matrix.tiling import global_to_tiles, tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl
from ..tile_ops import mixed as mx
from ..tile_ops import panel_kernels as pk
from ..types import ceil_div, dtype_name, total_ops
from . import dist_step as ds
from .triangular import triangular_solve


def _gen_to_std_twosolve(uplo: str, a: Matrix, b_factor: Matrix, donate: bool = False) -> Matrix:
    """Hermitianize, then two whole solves, each consuming its right-hand
    side; the final merge takes the opposite triangle from ``a``."""
    ah = mops.hermitianize(a, uplo)
    if uplo == "L":
        x = triangular_solve("L", "L", "N", "N", 1.0, b_factor, ah, donate_b=True)
        y = triangular_solve("R", "L", "C", "N", 1.0, b_factor, x, donate_b=True)
    else:
        x = triangular_solve("L", "U", "C", "N", 1.0, b_factor, ah, donate_b=True)
        y = triangular_solve("R", "U", "N", "N", 1.0, b_factor, x, donate_b=True)
    return mops.merge_triangle(y, a, uplo, donate_new=True, donate_orig=donate)


# ---------------------------------------------------------------------------
# Tile steps shared by both blocked forms
# ---------------------------------------------------------------------------

def _solve(side: str, uplo: str, op: str, lkk, b, inv, fused: bool):
    """One panel solve against the triangle ``lkk``: the strip-solve
    kernel with ``fused``, else ``blas.trsm_panel`` (with the step's
    refined inverse ``inv`` under ``f64_trsm=mixed``)."""
    if fused:
        return pk.panel_solve(side, uplo, op, "N", lkk, b)
    return tb.trsm_panel(side, uplo, op, "N", lkk, b, inv_a=inv)


def _hegst_diag(uplo: str, akk, lkk, inv, fused: bool):
    """The transformed diagonal tile in full Hermitian form:
    ``inv(L) herm(Akk) inv(L)^H`` (uplo 'L') or ``inv(U^H) herm(Akk)
    inv(U)`` ('U'): the tile HEGST's solves
    (:func:`..tile_ops.lapack.hegst_full`) with the step's panel solves."""
    w = tl.hegst_full(uplo, akk, lkk,
                      lambda side, up, op, t, x: _solve(side, up, op, t, x, inv, fused))
    return tb.hermitian_from(w, uplo)


def _step_inv(uplo: str, lkk):
    """The refined inverse of the step's triangle under
    ``f64_trsm=mixed``, shared by all its solves; else None."""
    if tb.trsm_panel_uses_mixed(lkk.dtype, lkk.device.type):
        return mx.tri_inv_refined(tb.tri_mask(lkk, uplo), lower=uplo == "L")
    return None


# ---------------------------------------------------------------------------
# Local blocked form (reference gen_to_std.py:138-251)
# ---------------------------------------------------------------------------

def _hegst_local(a: torch.Tensor, l: torch.Tensor, *, uplo: str, nb: int,
                 lookahead: bool = False, panel_fused: bool = False) -> torch.Tensor:
    """Transform the ``(n, n)`` tensor ``a`` IN PLACE with the factor
    ``l`` (read only) and return it. The opposite triangle of ``a`` is not
    the result's (the caller merges it back)."""
    n = a.shape[0]
    for k in range(ceil_div(n, nb)):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        lkk = l[k0:k1, k0:k1]
        inv = _step_inv(uplo, lkk)
        wn = min(nb, n - k1)
        if uplo == "L":
            if k0 > 0:
                rowk = tb.trsm_panel("L", "L", "N", "N", lkk, a[k0:k1, :k0], inv_a=inv)
                a[k0:k1, :k0] = rowk
                if k1 < n:
                    a[k1:, :k0] -= tb.gemm(l[k1:, k0:k1], rowk)
            w = _hegst_diag(uplo, a[k0:k1, k0:k1], lkk, inv, panel_fused)
            a[k0:k1, k0:k1] = w
            if k1 == n:
                continue
            l21 = l[k1:, k0:k1]
            p = _solve("R", "L", "C", lkk, a[k1:, k0:k1], inv, panel_fused)
            p = p - 0.5 * tb.gemm(l21, w)
            if lookahead:
                # the her2k's next block column first: a column block and a
                # row block of its product p l21^H
                strip = tb.gemm(p, l21[:wn], op_b="C") + tb.gemm(p[:wn], l21, op_b="C").mH
                a[k1:, k1:k1 + wn] -= torch.tril(strip)
                if n - k1 > wn:
                    a[k1 + wn:, k1 + wn:] = tb.her2k("L", "N", p[wn:], l21[wn:],
                                                     a[k1 + wn:, k1 + wn:], alpha=-1.0)
            else:
                a[k1:, k1:] = tb.her2k("L", "N", p, l21, a[k1:, k1:], alpha=-1.0)
            a[k1:, k0:k1] = p - 0.5 * tb.gemm(l21, w)
        else:
            if k0 > 0:
                colk = tb.trsm_panel("R", "U", "N", "N", lkk, a[:k0, k0:k1], inv_a=inv)
                a[:k0, k0:k1] = colk
                if k1 < n:
                    a[:k0, k1:] -= tb.gemm(colk, l[k0:k1, k1:])
            w = _hegst_diag(uplo, a[k0:k1, k0:k1], lkk, inv, panel_fused)
            a[k0:k1, k0:k1] = w
            if k1 == n:
                continue
            u12 = l[k0:k1, k1:]
            p = _solve("L", "U", "C", lkk, a[k0:k1, k1:], inv, panel_fused)
            p = p - 0.5 * tb.gemm(w, u12)
            if lookahead:
                # mirrored: the her2k's next block row first, from blocks of
                # its product p^H u12
                strip = (tb.gemm(p[:, :wn], u12, op_a="C")
                         + tb.gemm(p, u12[:, :wn], op_a="C").mH)
                a[k1:k1 + wn, k1:] -= torch.triu(strip)
                if n - k1 > wn:
                    a[k1 + wn:, k1 + wn:] = tb.her2k("U", "C", p[:, wn:], u12[:, wn:],
                                                     a[k1 + wn:, k1 + wn:], alpha=-1.0)
            else:
                a[k1:, k1:] = tb.her2k("U", "C", p, u12, a[k1:, k1:], alpha=-1.0)
            a[k0:k1, k1:] = p - 0.5 * tb.gemm(w, u12)
    return a


# ---------------------------------------------------------------------------
# Distributed blocked form (reference gen_to_std.py:256-728)
# ---------------------------------------------------------------------------

def _pair_product(x, y, use_mxu: bool):
    """All-pairs tile product ``out[r, c] = x[r] @ conj(y[c])^T`` of two
    tile batches, as one whole-rectangle product."""
    if use_mxu:
        nr, mb, nc = x.shape[0], x.shape[-2], y.shape[0]
        full = ds.oz_product(x.reshape(nr * mb, -1), y.conj().reshape(nc * mb, -1).mT)
        return full.reshape(nr, mb, nc, mb).permute(0, 2, 1, 3)
    return torch.einsum("rab,cdb->rcad", x, y.conj())


def _col_strip_product(x, y_tile, use_mxu: bool):
    """``out[r] = x[r] @ conj(y_tile)^T``: one tile column of
    :func:`_pair_product`."""
    if use_mxu:
        nr, mb = x.shape[0], x.shape[-2]
        return ds.oz_product(x.reshape(nr * mb, -1), y_tile.conj().mT).reshape(nr, mb, mb)
    return torch.einsum("rab,db->rad", x, y_tile.conj())


def _row_strip_product(x_tile, y, use_mxu: bool):
    """``out[c] = x_tile @ conj(y[c])^T``: one tile row of
    :func:`_pair_product`."""
    if use_mxu:
        nc, mb = y.shape[0], y.shape[-2]
        full = ds.oz_product(x_tile, y.conj().reshape(nc * mb, mb).mT)
        return full.reshape(mb, nc, mb).permute(1, 0, 2)
    return torch.einsum("ab,cdb->cad", x_tile, y.conj())


def _zero_outside(t: torch.Tensor, span) -> torch.Tensor:
    """Zero the slots of ``t`` outside ``span = [a, b)`` in place."""
    a, b = span
    t[:a].zero_()
    t[b:].zero_()
    return t


def _hegst_dist(lts: cc.Shards, lls: cc.Shards, dist, *, uplo: str, use_mxu: bool = False,
                lookahead: bool = False, comm_la: bool = False,
                panel_fused: bool = False) -> None:
    """Transform the distributed matrix whose rank ``(r, c)`` holds the
    shard ``lts[r][c]`` IN PLACE with the factor's shards ``lls[r][c]``
    (read only).

    The reference's ``_build_dist_hegst`` runs ``transform`` once per mesh
    coordinate inside ``shard_map``; here one controller runs each of its
    three phases for every rank (in the multi-process form each process
    for its own rank: loops over ``cc.local_ranks``, the owners' writes
    guarded), and :mod:`..comm.collectives` exchange the per-rank values
    between them:

    * ``chain`` (uplo 'L' :358, 'U' :513): the factor's and A's diagonal
      tiles to every rank, the diagonal transform on EVERY rank, the factor
      panel broadcast, the panel solve and first half-hemm on every rank,
      the A panel broadcast and both transposed panels;
    * ``step_pre`` (:413, :560): the deferred solve of row (column) k of
      every previous panel by its owners, its broadcast and product into
      the rows (columns) of the previous panels, the owner's diagonal and
      panel writes, and with ``lookahead`` the next column (row) of the
      her2k;
    * ``step_bulk`` (:481, :627): the rest of the her2k as two all-pairs
      products under the pair-mode mask, and the second half-hemm.

    Every rank runs the same shapes: the trailing slots start at the
    uniform slot of step k+1 (the reference's ``lu = max(0, ceil((k+2-P)
    / P))`` is :func:`..matrix.panel.uniform_slot_start` of k+1), and
    invalid slots are zeroed, not skipped. Each rank solves its own slot
    of column (row) k, as the reference does, though only the owner's is
    kept: the strip-solve kernel launches on every rank."""
    ctx = DistContext(dist)
    nt, mb, n = ctx.nt.row, ctx.mb, dist.size.row
    P, Q, ltr, ltc = ctx.P, ctx.Q, ctx.ltr, ctx.ltc
    lower = uplo == "L"

    def ranks(fn):
        return cc.per_rank(P, Q, fn)

    def indices(k):
        return (ctx.owner_r(k), ctx.owner_c(k), ctx.kr(k), ctx.kc(k),
                uniform_slot_start(k + 1, P), uniform_slot_start(k + 1, Q))

    def valid_rows(r, lu, count, k):
        return ds.valid_range(ctx.g_rows(r, lu, count), k, nt)

    def valid_cols(c, lu, count, k):
        return ds.valid_range(ctx.g_cols(c, lu, count), k, nt)

    def chain(k):
        """Step k's panel chain: a dict of per-rank values, the panel
        entries None past the reference's early exits."""
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        ts = min(mb, n - k * mb)
        diag = bcast_diag(ctx, lls, k)
        lkk = ranks(lambda r, c: pad_diag_identity(diag[r][c], ts))
        inv = ranks(lambda r, c: _step_inv(uplo, lkk[r][c]))
        akk = bcast_diag(ctx, lts, k)
        w = ranks(lambda r, c: _hegst_diag(uplo, akk[r][c], lkk[r][c], inv[r][c], panel_fused))
        ch = dict(lkk=lkk, inv=inv, akk=akk, w=w, fac=None, pan=None, vb=None, vt_a=None,
                  vt_f=None)
        # the panel axis: rows of column k (uplo 'L'), columns of row k ('U')
        count = (ltr - lu_r) if lower else (ltc - lu_c)
        if count == 0:
            return ch
        if lower:
            fac = col_panel(ctx, lls, k, lu=lu_r)
            span = ranks(lambda r, c: valid_rows(r, lu_r, count, k))
        else:
            fac = row_panel(ctx, lls, k, lu=lu_c)
            span = ranks(lambda r, c: valid_cols(c, lu_c, count, k))
        for r, c in cc.local_ranks(P, Q):
            _zero_outside(fac[r][c], span[r][c])
        ch["fac"] = fac
        if k == nt - 1:
            return ch

        def one(r, c):
            if lower:
                p = _solve("R", "L", "C", lkk[r][c], lts[r][c][lu_r:, kc], inv[r][c],
                           panel_fused)
                p = p - 0.5 * torch.matmul(fac[r][c], w[r][c])
            else:
                p = _solve("L", "U", "C", lkk[r][c], lts[r][c][kr, lu_c:], inv[r][c],
                           panel_fused)
                p = p - 0.5 * torch.matmul(w[r][c], fac[r][c])
            return _zero_outside(p, span[r][c])

        pan = ch["pan"] = ranks(one)
        count_t = (ltc - lu_c) if lower else (ltr - lu_r)
        if count_t == 0:
            return ch
        if lower:
            vb = cc.bcast(pan, COL_AXIS, owner_c)
            g_t = ranks(lambda r, c: ctx.g_cols(c, lu_c, count_t))
            vt_a = transpose_col_to_rows(ctx, vb, lu_r, g_t)
            vt_f = transpose_col_to_rows(ctx, fac, lu_r, g_t)
        else:
            vb = cc.bcast(pan, ROW_AXIS, owner_r)
            g_t = ranks(lambda r, c: ctx.g_rows(r, lu_r, count_t))
            vt_a = transpose_row_to_cols(ctx, vb, lu_c, g_t)
            vt_f = transpose_row_to_cols(ctx, fac, lu_c, g_t)
        for r, c in cc.local_ranks(P, Q):
            span_t = ds.valid_range(g_t[r][c], k, nt)
            _zero_outside(vt_a[r][c], span_t)
            _zero_outside(vt_f[r][c], span_t)
        ch.update(vb=vb, vt_a=vt_a, vt_f=vt_f)
        return ch

    def deferred_solve(k, ch):
        """Row (column) k of every previous panel: solved by the owners of
        row (column) k, broadcast, and its product with the factor panel
        subtracted from the rows (columns) of the previous panels."""
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        ub = ceil_div(k, Q if lower else P)   # local slots whose global index may be < k
        if ub == 0:
            return
        lkk, inv, fac = ch["lkk"], ch["inv"], ch["fac"]
        prev = ranks(lambda r, c: int(np.searchsorted(
            ctx.g_cols(c, 0, ub) if lower else ctx.g_rows(r, 0, ub), k)))

        def mine(r, c):
            if (r != owner_r) if lower else (c != owner_c):
                return lts[r][c][kr, :ub] if lower else lts[r][c][:ub, kc]
            if lower:
                new = tb.trsm_panel("L", "L", "N", "N", lkk[r][c], lts[r][c][kr, :ub],
                                    inv_a=inv[r][c])
                lts[r][c][kr, :prev[r][c]] = new[:prev[r][c]]
            else:
                new = tb.trsm_panel("R", "U", "N", "N", lkk[r][c], lts[r][c][:ub, kc],
                                    inv_a=inv[r][c])
                lts[r][c][:prev[r][c], kc] = new[:prev[r][c]]
            return _zero_outside(new, (0, prev[r][c]))

        solved = ranks(mine)
        if fac is None:
            return
        got = cc.bcast(solved, ROW_AXIS, owner_r) if lower else cc.bcast(solved, COL_AXIS,
                                                                          owner_c)
        for r, c in cc.local_ranks(P, Q):
            if lower:
                # A_ij -= L_ik A_kj over my rows i > k and columns j < k
                upd = _pair_product(fac[r][c], got[r][c].conj().mT, use_mxu)
                a, b = valid_rows(r, lu_r, ltr - lu_r, k)
                lts[r][c][lu_r + a:lu_r + b, :prev[r][c]] -= upd[a:b, :prev[r][c]]
            else:
                # A_ji -= A_jk U_ki over my rows j < k and columns i > k
                upd = _pair_product(got[r][c], fac[r][c].conj().mT, use_mxu)
                a, b = valid_cols(c, lu_c, ltc - lu_c, k)
                lts[r][c][:prev[r][c], lu_c + a:lu_c + b] -= upd[:prev[r][c], a:b]

    def write_panel(k, values):
        """The owner column's (row's) valid panel slots of step k."""
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        for r, c in cc.local_ranks(P, Q):
            if lower and c == owner_c:
                a, b = valid_rows(r, lu_r, ltr - lu_r, k)
                lts[r][c][lu_r + a:lu_r + b, kc] = values[r][c][a:b]
            elif not lower and r == owner_r:
                a, b = valid_cols(c, lu_c, ltc - lu_c, k)
                lts[r][c][kr, lu_c + a:lu_c + b] = values[r][c][a:b]

    def second_half(ch):
        """The panel after its second half-hemm, per rank."""
        pan, fac, w = ch["pan"], ch["fac"], ch["w"]
        return ranks(lambda r, c: pan[r][c] - 0.5 * (torch.matmul(fac[r][c], w[r][c]) if lower
                                                     else torch.matmul(w[r][c], fac[r][c])))

    def step_pre(k, ch) -> bool:
        """Returns whether the next column (row) was updated here."""
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        deferred_solve(k, ch)
        if cc.is_local(owner_r, owner_c):
            w, akk = ch["w"][owner_r][owner_c], ch["akk"][owner_r][owner_c]
            other = "U" if lower else "L"
            lts[owner_r][owner_c][kr, kc] = tb.tri_mask(w, uplo) + tb.tri_mask(akk, other, k=-1)
        if ch["pan"] is None:
            return False
        write_panel(k, ch["pan"])
        if ch["vt_f"] is None:
            write_panel(k, second_half(ch))
            return False
        if not (lookahead and k + 1 < nt):
            return False
        vb, vt_a, vt_f = ch["vb"], ch["vt_a"], ch["vt_f"]
        if lower:
            c1, kc1 = ctx.owner_c(k + 1), ctx.kc(k + 1)
            for r, c in cc.local_ranks(P, Q):
                if c != c1:
                    continue
                j = kc1 - lu_c
                upd = (_col_strip_product(vb[r][c], vt_f[r][c][j], use_mxu)
                       + _col_strip_product(ch["fac"][r][c], vt_a[r][c][j], use_mxu))
                g = ctx.g_rows(r, lu_r, ltr - lu_r)
                on = np.flatnonzero(g == k + 1)
                ds.sub_masked_rows(lts[r][c][lu_r:, kc1], upd, ds.valid_range(g, k + 1, nt),
                                 int(on[0]) if on.size else None, True)
        else:
            r1, kr1 = ctx.owner_r(k + 1), ctx.kr(k + 1)
            for r, c in cc.local_ranks(P, Q):
                if r != r1:
                    continue
                i = kr1 - lu_r
                upd = (_row_strip_product(vt_a[r][c][i].conj().mT, ch["fac"][r][c].conj().mT,
                                          use_mxu)
                       + _row_strip_product(vt_f[r][c][i].conj().mT, vb[r][c].conj().mT,
                                            use_mxu))
                g = ctx.g_cols(c, lu_c, ltc - lu_c)
                on = np.flatnonzero(g == k + 1)
                ds.sub_masked_rows(lts[r][c][kr1, lu_c:], upd, ds.valid_range(g, k + 1, nt),
                                 int(on[0]) if on.size else None, False)
        return True

    def step_bulk(k, ch, stripped: bool) -> None:
        if ch["pan"] is None or ch["vt_f"] is None:
            return
        *_, lu_r, lu_c = indices(k)
        nrows, ncols = ltr - lu_r, ltc - lu_c
        vb, vt_a, vt_f, fac = ch["vb"], ch["vt_a"], ch["vt_f"], ch["fac"]
        for r, c in cc.local_ranks(P, Q):
            block = lts[r][c][lu_r:, lu_c:]
            mode = to_device(ds.pair_modes(ctx.g_rows(r, lu_r, nrows),
                                         ctx.g_cols(c, lu_c, ncols), k, nt, uplo, stripped),
                             block.device, torch.int32)
            if lower:
                # A_ij -= P_i L_jk^H + L_ik P_j^H
                upd = (_pair_product(vb[r][c], vt_f[r][c], use_mxu)
                       + _pair_product(fac[r][c], vt_a[r][c], use_mxu))
            else:
                # A_ij -= P_ki^H U_kj + U_ki^H P_kj
                upd = (_pair_product(vt_a[r][c].conj().mT, fac[r][c].conj().mT, use_mxu)
                       + _pair_product(vt_f[r][c].conj().mT, vb[r][c].conj().mT, use_mxu))
            ds.sub_masked_pairs(block, upd, mode, uplo)
            del upd
        write_panel(k, second_half(ch))

    def chain_comm_counts(k):
        """Collectives ``chain(k)`` runs per grid axis: the two diagonal
        bcast2d on each, the factor panel's broadcast where trailing slots
        exist, and on a full chain the A panel's broadcast and the two
        transposed panels' exchanges."""
        *_, lu_r, lu_c = indices(k)
        nrows, ncols = ltr - lu_r, ltc - lu_c
        full = k < nt - 1 and nrows > 0 and ncols > 0
        if lower:
            return 2 + (2 if full else 0), 2 + (1 if nrows > 0 else 0) + (1 if full else 0)
        return 2 + (1 if ncols > 0 else 0) + (1 if full else 0), 2 + (2 if full else 0)

    ch_next = None
    for k in range(nt):
        if ch_next is not None:
            ch = ch_next
        else:
            with obs.named_span("hegst.step%03d.panel", k):
                ch = chain(k)
        with obs.named_span("hegst.step%03d.strip", k):
            stripped = step_pre(k, ch)
        # comm_la: step k+1's chain reads column (row) k+1, which the
        # stripped bulk of step k leaves alone
        ch_next = None
        if comm_la and stripped:
            with obs.named_span("hegst.step%03d.panel", k + 1):
                ch_next = chain(k + 1)
            if obs.metrics_active():
                n_row, n_col = chain_comm_counts(k + 1)
                cc.record_overlapped("hegst_dist", ROW_AXIS, n_row)
                cc.record_overlapped("hegst_dist", COL_AXIS, n_col)
        with obs.named_span("hegst.step%03d.bulk", k):
            step_bulk(k, ch, stripped)


def gen_to_std(uplo: str, a: Matrix, b_factor: Matrix, *, donate: bool = False,
               with_info: bool = False):
    """Transform ``a`` (Hermitian, stored in its ``uplo`` triangle) with
    ``b_factor``, the Cholesky factor of B in the same ``uplo``, on
    ``a``'s device(s). Returns a new Matrix whose ``uplo`` triangle holds
    the standard-form matrix; the opposite strict triangle is ``a``'s.

    ``donate=True`` releases ``a``'s storage to the transform (``a`` must
    not be used afterwards); ``b_factor`` is never written. With
    ``with_info=True`` returns ``(out, info)``: an int32 device tensor, 0
    when the factor's diagonal is finite and nonzero, else the 1-based
    first singular global column (the result is the same either way).

    Under ``DLAF_AUTOTUNE`` the call runs under its site's route (op
    ``hegst``) and, when ``a`` survives and the cadence is due, the
    transform's Hutchinson residual (``c = 100``) feeds the route table."""
    from .. import autotune

    steer = autotune.steering_for_matrix("hegst", a)
    if steer is None:
        return _gen_to_std_entry(uplo, a, b_factor, donate=donate, with_info=with_info)
    with steer.applied():
        out = _gen_to_std_entry(uplo, a, b_factor, donate=donate, with_info=with_info)
    if not donate and steer.probe_due:
        from ..obs import accuracy

        res = out[0] if with_info else out
        steer.observe(accuracy.hegst_residual(uplo, a, b_factor, res), c=100.0, of=res,
                      attrs={"entry": "gen_to_std", "uplo": uplo})
    return out


def _gen_to_std_entry(uplo, a, b_factor, *, donate, with_info):
    dlaf_assert(uplo in ("L", "U"), f"gen_to_std: bad uplo {uplo!r}")
    info = hinfo.matrix_diag_info(b_factor, singular=True) if with_info else None
    dlaf_assert(a.size == b_factor.size, "gen_to_std: A/B size mismatch")
    dlaf_assert(a.block_size == b_factor.block_size, "gen_to_std: block mismatch")
    dev = a.device.type
    if dev == "cuda":
        # the reference's float32 products are full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    nt = a.dist.nr_tiles.row
    hegst_impl = config.resolve("hegst_impl", dev)
    use_twosolve = hegst_impl == "twosolve" or config.resolve_step_mode(nt, dev) == "scan"
    nb = a.block_size.row
    # twosolve has no panel chain of its own: its pivot solves route inside
    # triangular_solve
    panel_fused = not use_twosolve and pk.panel_uses_fused(a.dtype, nb, dev)
    n = a.size.row
    span = obs.entry_span("gen_to_std", lambda: dict(
        flops=total_ops(a.dtype, n ** 3 / 2, n ** 3 / 2), n=n, nb=nb, uplo=uplo,
        dtype=dtype_name(a.dtype), impl="twosolve" if use_twosolve else hegst_impl,
        panel_impl="fused" if panel_fused else "xla", **at_routes.span_attrs(),
        grid=f"{a.dist.grid_size.row}x{a.dist.grid_size.col}"))
    with span:
        res = _gen_to_std(uplo, a, b_factor, donate, use_twosolve, panel_fused)
    return (res, info) if with_info else res


def _gen_to_std(uplo, a, b_factor, donate, use_twosolve, panel_fused):
    if use_twosolve:
        return _gen_to_std_twosolve(uplo, a, b_factor, donate=donate)
    dev = a.device.type
    nb = a.block_size.row
    lookahead = config.resolve("cholesky_lookahead", dev) == "1"
    if not a.distributed:
        out = obs.telemetry.call("gen_to_std.local", _hegst_local,
                                 tiles_to_global(a.storage, a.dist),
                                 tiles_to_global(b_factor.storage, b_factor.dist), uplo=uplo,
                                 nb=nb, lookahead=lookahead, panel_fused=panel_fused)
        return mops.merge_triangle(a.with_storage(global_to_tiles(out, a.dist)), a, uplo,
                                   donate_new=True, donate_orig=donate)
    # one set of slot indices serves A and the factor: both axes must align
    assert_slot_aligned(a.dist, b_factor.dist, rows=True, cols=True,
                        what="gen_to_std(A, B_factor)")
    P, Q = a.dist.grid_size.row, a.dist.grid_size.col
    use_mxu = tb.f64_gemm_uses_mxu(a.dtype, nb, dev)
    shards = a.storage if donate else [s if s is None else s.clone() for s in a.storage]
    if donate:
        a.storage = None
    obs.telemetry.call("gen_to_std.dist", _hegst_program,
                       cc.per_rank(P, Q, lambda r, c: shards[r * Q + c]),
                       cc.per_rank(P, Q, lambda r, c: b_factor.storage[r * Q + c]), a.dist,
                       uplo=uplo, use_mxu=use_mxu, lookahead=lookahead,
                       comm_la=lookahead and config.resolve("comm_lookahead", dev) == "1",
                       panel_fused=panel_fused)
    return Matrix(a.dist, shards, a.grid)


def _hegst_program(lts, lls, dist, **kw):
    """:func:`_hegst_dist` in place on ``lts``, returning them."""
    _hegst_dist(lts, lls, dist, **kw)
    return lts
