"""Blocked Cholesky factorization, local and distributed.

Port of ``dlaf_tpu/algorithms/cholesky.py`` (``cholesky`` :1733,
``_cholesky`` :1768, ``_cholesky_local`` :105-406, ``_cholesky_local_scan``
:416-699, ``_build_dist_cholesky`` :731-1183): the right-looking tile
algorithm — potrf on the diagonal block, panel trsm, trailing herk/gemm
update. On one device, on every local route of the reference:

* ``_cholesky_local``: trailing "loop", "biggemm", "invgemm", "xla" and
  "ozaki" (f64/complex128: mixed-precision panels from
  :mod:`..tile_ops.mixed`, panel application and trailing products on the
  Ozaki int8 route of :mod:`..tile_ops.ozaki`; other types run
  "biggemm"), with the panel kernels (``panel_fused``) or the fused step
  kernels (``step_fused``) where the dtype allows;
* ``_cholesky_local_scan`` (trailing "scan"): uniform full-size masked
  steps over telescoped segments, the panel and trailing routes chosen by
  ``f64_trsm``/``f64_gemm``, the fused factor+solve kernel with
  ``step_fused``.

The JAX functions are pure and copy at every ``.at[].set``; this port
updates ONE working tensor in place, so the input copy is the only
full-matrix buffer besides the trailing products. PyTorch runs eagerly on
one stream, so the reference's look-ahead *carry* (which frees XLA to
overlap panel k+1 with the bulk update of step k) has no dataflow meaning
here: ``lookahead`` keeps only the reference's ORDER (the next panel
column is updated before the rest) and reads everything back from the
working tensor. The factor is bitwise the same with lookahead on or off
wherever both orders compute the same products: the "loop", fused-step,
real "ozaki" and scan routes (on complex Ozaki products the strip is four
real products where the other order forms it inside a herk); on the
native biggemm route the split
products differ in shape, which the CPU's BLAS sums in the same order (the
tests pin it) but the card's library need not.

On a grid of several ranks, :func:`_cholesky_dist`: the reference's unrolled
distributed builder as one controller's loop over the ranks (see its
docstring); with trailing "scan", :func:`_cholesky_dist_scan`, the
reference's distributed scan builder (``_build_dist_cholesky_scan``
:1208-1686), as a Python loop at the reference's uniform shapes.

Under ``DLAF_AUTOTUNE`` (:mod:`..autotune`) :func:`cholesky` takes its
site's route from the route table around the whole call and, when the
input survives (``donate=False``), feeds the factor's Hutchinson probe
back (the reference's ``cholesky.py:1738-1760``).

Records (:mod:`..obs`), as the reference's: the ``cholesky`` entry span
(unfenced, with the reference's flop model and attrs,
``cholesky.py:1842-1850``); the program telemetry sites
``cholesky.local``, ``cholesky.local_scan`` and ``cholesky.dist``
(:mod:`..obs.telemetry`); ``dlaf_algo_tile_ops_total{algo,op}`` and
``dlaf_cholesky_steps_total{algo,mode}`` per step as it runs (the
reference counts them once per traced program, :mod:`..obs` has the
rule); and on a grid the per-step ``cholesky.step<k>`` phases
``.panel``/``.strip``/``.bulk`` (profiler names with a trace directory)
and ``dlaf_comm_overlapped_total`` for the panel chain hoisted by
``comm_lookahead``.

The trailing products outside the kernels are ``torch.matmul``, as the
reference leaves them to XLA. On a CUDA device ``cholesky`` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` before it runs: a
float32 product stays in full float32.
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
from ..health.registry import route_available
from ..matrix.matrix import Matrix
from ..matrix.panel import (DistContext, bcast_diag, pad_diag_identity, to_device,
                            transpose_col_to_rows, transpose_row_to_cols, uniform_slot_start)
from ..matrix.tiling import global_to_tiles, tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl
from ..tile_ops import mixed as mx
from ..tile_ops import ozaki as oz
from ..tile_ops import ozaki_kernels as ok
from ..tile_ops import panel_kernels as pk
from ..tile_ops import update_kernels as uk
from ..types import ceil_div, dtype_name, telescope_segments, telescope_windows, total_ops
from . import dist_step as ds

_F64 = (torch.float64, torch.complex128)


def _count_step_modes(algo: str, overlapped: int, serialized: int) -> None:
    """Steps run in the look-ahead order (the next panel column first) and
    in the plain order: ``dlaf_cholesky_steps_total{algo,mode}``."""
    if obs.metrics_active():
        if overlapped:
            obs.counter("dlaf_cholesky_steps_total", algo=algo, mode="overlapped").inc(overlapped)
        if serialized:
            obs.counter("dlaf_cholesky_steps_total", algo=algo, mode="serialized").inc(serialized)


def _count_local_step(k: int, nt: int, lookahead: bool) -> None:
    """Step k's tile ops on one rank: one potrf and (nt-k-1) panel-solve
    tiles, and the trailing update's tile pairs under the loop schedule."""
    if obs.metrics_active():
        tail = nt - k - 1
        for op, cnt in (("potrf", 1), ("trsm", tail), ("herk", tail),
                        ("gemm", tail * (tail - 1) // 2)):
            obs.counter("dlaf_algo_tile_ops_total", algo="cholesky", op=op).inc(cnt)
        _count_step_modes("cholesky", *((1, 0) if lookahead and tail else (0, 1)))


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


def _oz_gram(x: torch.Tensor, uplo: str) -> torch.Tensor:
    """``x @ x^H`` on the Ozaki route, valid in the ``uplo`` triangle only
    (no mirror is formed)."""
    gram = oz.herk_c128 if x.is_complex() else oz.syrk_f64
    return gram(x, slices=tb._oz_slices(), tri=uplo)


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


def _whole_matrix(a: torch.Tensor, uplo: str, *, out=None,
                  factor=tl._chol_lower_nan) -> torch.Tensor:
    """The "xla" route: one library factor of the whole matrix (NaN from
    the first failing column on), the other triangle passed through.
    ``a`` may carry leading batch axes (the batched serving programs);
    ``out`` (it may be ``a``) receives the result in place; ``factor`` is
    the lower factor of the Hermitian expansion."""
    n = a.shape[-1]
    keep = torch.ones((n, n), dtype=torch.bool, device=a.device)
    if uplo == "L":
        l, keep = factor(torch.tril(a) + torch.tril(a, -1).mH), keep.tril()
    else:
        l, keep = factor(torch.triu(a) + torch.triu(a, 1).mH).mH, keep.triu()
    return torch.where(keep, l, a) if out is None else torch.where(keep, l, a, out=out)


def _cholesky_local(a: torch.Tensor, *, uplo: str, nb: int, trailing: str = "loop",
                    lookahead: bool = False, with_info: bool = False,
                    panel_fused: bool = False, step_fused: bool = False):
    """Factor the ``(n, n)`` tensor ``a`` IN PLACE in its ``uplo`` triangle
    (the other triangle passes through; the "xla" route returns a new
    tensor); returns the factor, or ``(factor, info)`` with ``with_info``.
    Panel routes: composed (torch.linalg), ``panel_fused`` (potrf and
    strip-solve kernels), ``step_fused`` (one fused step per strip-bearing
    block step), "invgemm" (the panel from the tile's explicit inverse),
    and for f64/complex128 on "ozaki" the mixed factor + Ozaki products."""
    n = a.shape[0]
    use_oz = trailing == "ozaki" and a.dtype in _F64
    if trailing == "ozaki" and not use_oz:
        trailing = "biggemm"
    if trailing == "xla" and n:
        out = _whole_matrix(a, uplo)
        return (out, hinfo.local_factor_info(out)) if with_info else out
    other = "U" if uplo == "L" else "L"
    nt = ceil_div(n, nb) if n else 0
    for k in range(nt):
        _count_local_step(k, nt, lookahead)
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
        if use_oz:
            # f32 seed + Newton: the factor and its explicit inverse
            fac, fac_inv = mx.potrf_inv_refined(uplo, blk)
            diag = fac + tb.tri_mask(blk, other, k=-1)
        else:
            diag = pk.potrf(uplo, blk) if panel_fused else tl.potrf(uplo, blk)
        a[k0:k1, k0:k1] = diag
        if k1 == n:
            break
        m = n - k1
        w = min(nb, m)
        if uplo == "L":
            colsrc = a[k1:, k0:k1]
            if use_oz:
                panel = tb.mm_mxu(colsrc, fac_inv.mH)
            elif trailing == "invgemm":
                dinv = tb.trsm("L", "L", "N", "N", diag, torch.eye(k1 - k0, dtype=a.dtype,
                                                                   device=a.device))
                panel = colsrc @ dinv.mH
            elif panel_fused:
                panel = pk.panel_solve("R", "L", "C", "N", diag, colsrc)
            else:
                panel = tb.trsm("R", "L", "C", "N", diag, colsrc)
            a[k1:, k0:k1] = panel
            if trailing == "loop":
                _loop_lower(a, panel, k1, k + 1, nt, nb, n)
            elif lookahead:
                # next panel column first, then the row-trimmed rest
                cmask = (torch.arange(m, device=a.device)[:, None]
                         >= torch.arange(w, device=a.device)[None, :])
                pj = panel[:w].mH
                _add_masked(a[k1:, k1:k1 + w], ds.oz_product(panel, pj) if use_oz
                            else panel @ pj, cmask)
                if m > w:
                    pr = panel[w:]
                    _add_tri(a[k1 + w:, k1 + w:], _oz_gram(pr, "L") if use_oz else pr @ pr.mH,
                             "L")
            else:
                _add_tri(a[k1:, k1:], _oz_gram(panel, "L") if use_oz else panel @ panel.mH,
                         "L")
        else:
            rowsrc = a[k0:k1, k1:]
            if use_oz:
                panel = tb.mm_mxu(fac_inv.mH, rowsrc)
            elif trailing == "invgemm":
                dinv = tb.trsm("L", "U", "N", "N", diag, torch.eye(k1 - k0, dtype=a.dtype,
                                                                   device=a.device))
                panel = dinv.mH @ rowsrc
            elif panel_fused:
                panel = pk.panel_solve("L", "U", "C", "N", diag, rowsrc)
            else:
                panel = tb.trsm("L", "U", "C", "N", diag, rowsrc)
            a[k0:k1, k1:] = panel
            if trailing == "loop":
                _loop_upper(a, panel, k1, k + 1, nt, nb, n)
            elif lookahead:
                rmask = (torch.arange(w, device=a.device)[:, None]
                         <= torch.arange(m, device=a.device)[None, :])
                pt = panel.mH
                _add_masked(a[k1:k1 + w, k1:], ds.oz_product(pt[:w], panel) if use_oz
                            else panel[:, :w].mH @ panel, rmask)
                if m > w:
                    pr = panel[:, w:]
                    _add_tri(a[k1 + w:, k1 + w:], _oz_gram(pt[w:], "U") if use_oz
                             else pr.mH @ pr, "U")
            else:
                _add_tri(a[k1:, k1:], _oz_gram(panel.mH, "U") if use_oz else panel.mH @ panel,
                         "U")
    return (a, hinfo.local_factor_info(a)) if with_info else a


def _scan_panel(acc, blk, k0, nb, m, uplo, use_mxu, use_mixed, panel_fused, step_fused):
    """The panel half of one uniform scan step on the (m, m) block ``acc``
    (in place): the pivot tile's factor, the whole block column (uplo 'L')
    or row ('U') solved and written back, rows/columns at or above the
    pivot kept. Returns the panel, zero at and above the pivot."""
    other = "U" if uplo == "L" else "L"
    if use_mixed:
        fac, fac_inv = mx.potrf_inv_refined(uplo, blk)
        diag = fac + tb.tri_mask(blk, other, k=-1)
    elif step_fused:
        # the potrf is deferred into the fused factor+solve kernel
        diag = None
    else:
        diag = pk.potrf(uplo, blk) if panel_fused else tl.potrf(uplo, blk)
    if diag is not None:
        acc[k0:k0 + nb, k0:k0 + nb] = diag
    below = torch.arange(m, device=acc.device) >= k0 + nb
    if uplo == "L":
        col = acc[:, k0:k0 + nb]
        if use_mixed:
            inv_t = fac_inv.mH
            pfull = tb.mm_mxu(col, inv_t) if use_mxu else col @ inv_t
        elif step_fused:
            # col's pivot rows hold the unfactored tile; the write-back
            # below restores the factored one
            diag, pfull = pk.factor_solve("L", blk, col)
        elif panel_fused:
            pfull = pk.panel_solve("R", "L", "C", "N", diag, col)
        else:
            pfull = tb.trsm("R", "L", "C", "N", diag, col)
        keep = below[:, None]
        panel = torch.where(keep, pfull, 0.0)
        acc[:, k0:k0 + nb] = torch.where(keep, pfull, col)
    else:
        row = acc[k0:k0 + nb, :]
        if use_mixed:
            inv_t = fac_inv.mH
            pfull = tb.mm_mxu(inv_t, row) if use_mxu else inv_t @ row
        elif step_fused:
            diag, pfull = pk.factor_solve("U", blk, row)
        elif panel_fused:
            pfull = pk.panel_solve("L", "U", "C", "N", diag, row)
        else:
            pfull = tb.trsm("L", "U", "C", "N", diag, row)
        keep = below[None, :]
        panel = torch.where(keep, pfull, 0.0)
        acc[k0:k0 + nb, :] = torch.where(keep, pfull, row)
    if step_fused:
        acc[k0:k0 + nb, k0:k0 + nb] = diag
    return panel


def _cholesky_local_scan(a: torch.Tensor, *, uplo: str, nb: int, use_mxu: bool = False,
                         use_mixed: bool = False, lookahead: bool = False,
                         with_info: bool = False, panel_fused: bool = False,
                         step_fused: bool = False):
    """The scan formulation of the local factorization: every step runs at
    the uniform full size of its segment, the panel the WHOLE block column
    (rows at and above the pivot masked) and the trailing update one FULL
    masked product, over telescoped segments that track the shrinking
    trailing block (:func:`..types.telescope_segments`). The reference
    scans this body with ``lax.scan`` to compile O(1) programs; here it is
    a Python loop, kept at the reference's shapes and masks so the same
    products are formed.

    ``use_mixed`` (``f64_trsm="mixed"``) factors panels with the mixed
    factor+inverse, ``use_mxu`` (``f64_gemm="mxu"``) forms the panel
    application and the trailing products on the Ozaki route,
    ``step_fused`` runs the fused factor+solve kernel, ``panel_fused`` the
    panel kernels. ``lookahead`` defers each step's bulk product into the
    next step, after that step's panel and before its eager next-column
    strip, which is the serial per-cell order: the factor is bitwise the
    same. A ragged ``n`` is padded with an identity tail (a new tensor);
    otherwise ``a`` is factored in place."""
    n = a.shape[0]
    if n == 0:
        return (a, torch.zeros((), dtype=torch.int32, device=a.device)) if with_info else a
    nt = ceil_div(n, nb)
    npad = nt * nb - n
    if npad:
        # chol([[A, 0], [0, I]]) = [[L, 0], [0, I]]: the pad never touches A
        full = torch.zeros((nt * nb, nt * nb), dtype=a.dtype, device=a.device)
        full[:n, :n] = a
        full.diagonal()[n:] = 1
        a = full

    def gram(x):
        """Masked panel self-product on the configured trailing route,
        valid in the stored triangle."""
        return _oz_gram(x, uplo) if use_mxu else x @ x.mH

    def step(acc, k, m):
        k0 = k * nb
        blk = acc[k0:k0 + nb, k0:k0 + nb].clone()
        panel = _scan_panel(acc, blk, k0, nb, m, uplo, use_mxu, use_mixed, panel_fused,
                            step_fused)
        # the panel is zero at and above the pivot, so the product lives in
        # the trailing block; restrict it to the stored triangle
        _add_tri(acc, gram(panel if uplo == "L" else panel.mH), uplo)

    def step_la(acc, pp, k, m):
        """Software-pipelined body: the previous step's bulk product lands
        here, after this step's panel, then this panel's next-column strip
        eagerly."""
        k0 = k * nb
        blk = acc[k0:k0 + nb, k0:k0 + nb].clone()
        panel = _scan_panel(acc, blk, k0, nb, m, uplo, use_mxu, use_mixed, panel_fused,
                            step_fused)
        # the previous panel's bulk, less the columns (rows) its eager strip
        # already applied; the gram is scratch, so no (m, m) mask is made
        upd = gram(pp if uplo == "L" else pp.mH)
        if uplo == "L":
            upd[:, :k0 + nb] = 0
        else:
            upd[:k0 + nb] = 0
        _add_tri(acc, upd, uplo)
        idx = torch.arange(m, device=acc.device)
        if k0 + 2 * nb <= m:
            k1 = k0 + nb
            near = k1 + torch.arange(nb, device=acc.device)
            if uplo == "L":
                nstrip = panel[k1:k1 + nb].mH
                upd = ds.oz_product(panel, nstrip) if use_mxu else panel @ nstrip
                _add_masked(acc[:, k1:k1 + nb], upd, idx[:, None] >= near[None, :])
            else:
                nstrip = panel[:, k1:k1 + nb].mH
                upd = ds.oz_product(nstrip, panel) if use_mxu else nstrip @ panel
                _add_masked(acc[k1:k1 + nb, :], upd, near[:, None] <= idx[None, :])
        return panel

    off = 0
    pp = None
    for seg_len in telescope_segments(nt):
        m = (nt - off) * nb
        sub = a[off * nb:, off * nb:]
        if lookahead:
            _count_step_modes("cholesky_scan", seg_len, 0)
            # the pending panel crosses segments; the rows it drops are zero
            if pp is None:
                shape = (m, nb) if uplo == "L" else (nb, m)
                pp = torch.zeros(shape, dtype=a.dtype, device=a.device)
            else:
                pp = pp[-m:] if uplo == "L" else pp[:, -m:]
            for k in range(seg_len):
                pp = step_la(sub, pp, k, m)
        else:
            _count_step_modes("cholesky_scan", 0, seg_len)
            for k in range(seg_len):
                step(sub, k, m)
        off += seg_len
    out = a[:n, :n]
    return (out, hinfo.local_factor_info(out)) if with_info else out


# ---------------------------------------------------------------------------
# Distributed (reference cholesky.py:709-1205)
# ---------------------------------------------------------------------------

def _masked_oz_update(afl, bfl, mode, nrows, ncols, mb):
    """Exact-flop float64 trailing contraction: Ozaki slices of the
    flattened row and column operands (both contracting their last axis)
    through the predicated pair kernel, pairs with mode 0 skipping their
    products. Returns the (nrows, ncols, mb, mb) update, unmasked at the
    element level (the caller applies its triangle masks)."""
    s = tb._oz_slices()
    sa = oz._scale(afl, -1)
    sb = oz._scale(bfl, -1)
    ia = torch.stack(oz._peel_slices(oz._normalize(afl, sa), s)).reshape(s, nrows, mb, mb)
    ib = torch.stack(oz._peel_slices(oz._normalize(bfl, sb), s)).reshape(s, ncols, mb, mb)
    hi, lo = ok.ozaki_masked_product(ia, ib, mode)
    acc = hi.double().add_(lo)
    del hi, lo
    return acc.mul_(4.0).mul_(sa.reshape(nrows, 1, mb, 1)).mul_(sb.reshape(1, ncols, 1, mb))


def _cholesky_dist(lts: cc.Shards, dist, *, uplo, use_pallas=False, use_mxu=False,
                   use_mixed=False, use_oz_pallas=False, lookahead=False, comm_la=False,
                   with_info=False, panel_fused=False, step_fused=False):
    """Factor the distributed matrix whose rank ``(r, c)`` holds the shard
    ``lts[r][c]`` (ltr, ltc, mb, mb), IN PLACE; returns the 1-based first
    failing column as an int32 tensor with ``with_info``, else None.

    The reference's ``_build_dist_cholesky`` runs ``factorize`` once per
    mesh coordinate inside ``shard_map``; here one controller runs each of
    its three phases for every rank in turn (in the multi-process form,
    :mod:`..comm.multihost`, each process for its own rank: the loops run
    over ``cc.local_ranks``, the owners' writes are guarded by
    ``cc.is_local`` and every process issues the same collectives), and
    the collectives of :mod:`..comm.collectives` exchange the per-rank
    values between phases:

    * ``panel_chain`` (:797-916): the diagonal tile to every rank
      (``bcast2d``), its factor on EVERY rank (the reference's redundant
      tiny compute: with ranks sharing a card the panel kernels launch P*Q
      times a step), the panel solve of each rank's rows, the panel
      broadcast along the column axis and the transposed panel from an
      all-gather along the row axis (uplo 'U': the mirror);
    * ``step_pre`` (:918-1005): the owners' diagonal and panel writes, and
      with ``lookahead`` the next column (row) updated first and carried;
    * ``step_bulk`` (:1007-1100): the rest of the trailing update.

    With ``comm_la`` step k+1's whole panel chain runs before step k's
    bulk update, reading only the carried column, in the reference's order
    (:1143-1169). Every rank runs the same shapes: the trailing block of a
    step starts at the uniform slots (:793-794) and padding slots and
    ranks are masked, not skipped, so each kernel launches once per rank
    per step. Routes, as the reference's: ``use_pallas`` the predicated
    update kernel (float32/bfloat16), ``use_mxu`` the Ozaki products
    (complex128 composed of real ones), ``use_oz_pallas`` their predicated
    pair kernel (float64), ``use_mixed`` the mixed panels, ``panel_fused``
    and ``step_fused`` the panel kernels. The factor is bitwise the same
    with ``lookahead``, ``comm_la`` and ``with_info`` on or off where the
    look-ahead strip forms the same products as the bulk (every route on
    the CPU, where the tests pin it); on the card the strip is a library
    product, and the update kernel need not sum in its order."""
    ctx = DistContext(dist)
    nt, mb, n = ctx.nt.row, ctx.mb, dist.size.row
    P, Q, ltr, ltc = ctx.P, ctx.Q, ctx.ltr, ctx.ltc
    other = "U" if uplo == "L" else "L"

    def ranks(fn):
        return cc.per_rank(P, Q, fn)

    def indices(k):
        return (ctx.owner_r(k), ctx.owner_c(k), ctx.kr(k), ctx.kc(k),
                uniform_slot_start(k + 1, P), uniform_slot_start(k + 1, Q))

    def solve(side, up, lkk, src, inv):
        if panel_fused:
            return pk.panel_solve(side, up, "C", "N", lkk, src)
        return tb.trsm_panel(side, up, "C", "N", lkk, src, inv_a=inv)

    def panel_chain(k, la):
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        if la is None:
            cand = ranks(lambda r, c: lts[r][c][kr, kc])
        else:
            slot = (kr if uplo == "L" else kc) - la[1]
            cand = ranks(lambda r, c: la[0][r][c][slot])
        diag = cc.bcast2d(cand, owner_r, owner_c)
        ts = min(mb, n - k * mb)
        diag = ranks(lambda r, c: pad_diag_identity(diag[r][c], ts))
        fuse_step = step_fused and not use_mixed and k < nt - 1 and (
            (ltr - lu_r) if uplo == "L" else (ltc - lu_c)) > 0
        inv = None
        if use_mixed:
            fi = ranks(lambda r, c: mx.potrf_inv_refined(uplo, diag[r][c]))
            lkk = ranks(lambda r, c: fi[r][c][0] + tb.tri_mask(diag[r][c], other, k=-1))
            inv = ranks(lambda r, c: fi[r][c][1])
        elif fuse_step:
            lkk = None
        else:
            lkk = ranks(lambda r, c: pk.potrf(uplo, diag[r][c]) if panel_fused
                        else tl.potrf(uplo, diag[r][c]))
        if k == nt - 1:
            return lkk, None, None, None
        lower = uplo == "L"
        # uplo 'L': the panel is block column k, solved on each rank's rows,
        # broadcast along the column axis, transposed over the row axis;
        # 'U': block row k, the mirror
        count = (ltr - lu_r) if lower else (ltc - lu_c)
        if count == 0:
            return lkk, None, None, None
        lu = lu_r if lower else lu_c
        g_own = ranks(lambda r, c: ctx.g_rows(r, lu_r, count) if lower
                      else ctx.g_cols(c, lu_c, count))

        def src(r, c):
            if la is not None:
                return la[0][r][c][lu - la[1]:]
            return lts[r][c][lu_r:, kc] if lower else lts[r][c][kr, lu_c:]

        if fuse_step:
            fs = ranks(lambda r, c: pk.factor_solve(uplo, diag[r][c], src(r, c)))
            lkk = ranks(lambda r, c: fs[r][c][0])
            pan = ranks(lambda r, c: fs[r][c][1])
        else:
            pan = ranks(lambda r, c: solve("R" if lower else "L", uplo, lkk[r][c], src(r, c),
                                           inv[r][c] if inv is not None else None))
        for r, c in cc.local_ranks(P, Q):
            a, b = ds.valid_range(g_own[r][c], k, nt)
            pan[r][c][:a].zero_()
            pan[r][c][b:].zero_()
        vb = cc.bcast(pan, COL_AXIS if lower else ROW_AXIS, owner_c if lower else owner_r)
        count_t = (ltc - lu_c) if lower else (ltr - lu_r)
        if count_t == 0:
            return lkk, pan, vb, None
        g_t = ranks(lambda r, c: ctx.g_cols(c, lu_c, count_t) if lower
                    else ctx.g_rows(r, lu_r, count_t))
        vt = (transpose_col_to_rows(ctx, vb, lu_r, g_t) if lower
              else transpose_row_to_cols(ctx, vb, lu_c, g_t))
        for r, c in cc.local_ranks(P, Q):
            a, b = ds.valid_range(g_t[r][c], k, nt)
            vt[r][c][:a].zero_()
            vt[r][c][b:].zero_()
        return lkk, pan, vb, vt

    def step_pre(k, ch):
        lkk, pan, vb, vt = ch
        owner_r, owner_c, kr, kc, lu_r, lu_c = indices(k)
        if cc.is_local(owner_r, owner_c):
            lts[owner_r][owner_c][kr, kc] = lkk[owner_r][owner_c]
        if pan is None:
            return None
        lower = uplo == "L"
        count = (ltr - lu_r) if lower else (ltc - lu_c)
        # the owner column (row) keeps its solved panel tiles
        for r, c in cc.local_ranks(P, Q):
            if (c != owner_c) if lower else (r != owner_r):
                continue
            g = ctx.g_rows(r, lu_r, count) if lower else ctx.g_cols(c, lu_c, count)
            a, b = ds.valid_range(g, k, nt)
            if lower:
                lts[r][c][lu_r + a:lu_r + b, kc] = pan[r][c][a:b]
            else:
                lts[r][c][kr, lu_c + a:lu_c + b] = pan[r][c][a:b]
        if vt is None or not (lookahead and k + 1 < nt):
            return None
        # the next column (row) first, carried to step k+1: one product of
        # the panel against this rank's slot-(k+1) transposed-panel tile,
        # the tile the bulk would have used, on the ranks that own k+1
        k1_own = ctx.owner_c(k + 1) if lower else ctx.owner_r(k + 1)
        slot1 = ctx.kc(k + 1) if lower else ctx.kr(k + 1)

        def one(r, c):
            col = lts[r][c][lu_r:, slot1] if lower else lts[r][c][slot1, lu_c:]
            if (c if lower else r) == k1_own:
                if lower:
                    panel, pk1 = vb[r][c], vt[r][c][slot1 - lu_c]
                    flat = panel.reshape(count * mb, mb)
                    upd = (ds.oz_product(flat, pk1.conj().mT) if use_mxu
                           else flat @ pk1.conj().mT).reshape(count, mb, mb)
                else:
                    panel, pk1 = vb[r][c], vt[r][c][slot1 - lu_r]
                    flat = panel.mT.reshape(count * mb, mb)
                    upd = (ds.oz_product(pk1.conj().mT, flat.mT) if use_mxu
                           else pk1.conj().mT @ flat.mT)
                    upd = upd.reshape(mb, count, mb).permute(1, 0, 2)
                g = ctx.g_rows(r, lu_r, count) if lower else ctx.g_cols(c, lu_c, count)
                a, b = ds.valid_range(g, k, nt)
                on = [i for i in range(a, b) if g[i] == k + 1]
                full = (on[0] + 1 if on else a, b)
                ds.sub_masked_rows(col, upd, full, on[0] if on else None, lower)
            return col.clone()

        return ranks(one), (lu_r if lower else lu_c)

    def step_bulk(k, ch, stripped):
        lkk, pan, vb, vt = ch
        if pan is None or vt is None:
            return
        *_, lu_r, lu_c = indices(k)
        nrows, ncols = ltr - lu_r, ltc - lu_c
        for r, c in cc.local_ranks(P, Q):
            block = lts[r][c][lu_r:, lu_c:]
            mode = to_device(ds.pair_modes(ctx.g_rows(r, lu_r, nrows),
                                         ctx.g_cols(c, lu_c, ncols), k, nt, uplo, stripped),
                             block.device, torch.int32)
            if uplo == "L":
                vr, vc = vb[r][c], vt[r][c]
            else:
                vc, vr = vb[r][c], vt[r][c]
            if use_pallas:
                # uplo 'U' passes transposed tiles: the kernel's
                # contraction stays vr @ vc^T (mode 3: tile upper)
                uk.masked_trailing_update(block, vr if uplo == "L" else vr.mT,
                                          vc if uplo == "L" else vc.mT, mode)
                continue
            if uplo == "L":
                afl, bfl = vr.reshape(nrows * mb, mb), vc.conj().reshape(ncols * mb, mb)
            else:
                afl = vr.conj().mT.reshape(nrows * mb, mb)
                bfl = vc.mT.reshape(ncols * mb, mb)
            if use_mxu and use_oz_pallas:
                upd = _masked_oz_update(afl, bfl, mode, nrows, ncols, mb)
            else:
                full = ds.oz_product(afl, bfl.mT) if use_mxu else afl @ bfl.mT
                upd = full.reshape(nrows, mb, ncols, mb).permute(0, 2, 1, 3)
            ds.sub_masked_pairs(block, upd, mode, uplo)

    def chain_comm_counts(k):
        """Collectives ``panel_chain(k)`` runs per grid axis: the diagonal
        bcast2d once on each; a full chain adds the panel broadcast on one
        axis and the transposed panel's exchange on the other."""
        *_, lu_r, lu_c = indices(k)
        nrows, ncols = ltr - lu_r, ltc - lu_c
        row = col = 1
        if k < nt - 1:
            if uplo == "L" and nrows > 0:
                col += 1
                if ncols > 0:
                    row += 1
            elif uplo == "U" and ncols > 0:
                row += 1
                if nrows > 0:
                    col += 1
        return row, col

    la = None
    ch_next = None
    for k in range(nt):
        if obs.metrics_active():
            obs.counter("dlaf_algo_tile_ops_total", algo="cholesky_dist", op="potrf").inc()
            obs.counter("dlaf_algo_tile_ops_total", algo="cholesky_dist",
                        op="trailing_pairs").inc((ltr - max(0, -(-(k + 2 - P) // P)))
                                                 * (ltc - max(0, -(-(k + 2 - Q) // Q))))
            _count_step_modes("cholesky_dist", *((1, 0) if lookahead and k + 1 < nt
                                                 else (0, 1)))
        with obs.named_span("cholesky.step%03d", k):
            if comm_la:
                if ch_next is not None:
                    ch = ch_next
                else:
                    with obs.named_span("cholesky.step%03d.panel", k):
                        ch = panel_chain(k, la)
                with obs.named_span("cholesky.step%03d.strip", k):
                    la = step_pre(k, ch)
                ch_next = None
                if k + 1 < nt and la is not None:
                    # step k+1's chain, hoisted ahead of step k's bulk
                    with obs.named_span("cholesky.step%03d.panel", k + 1):
                        ch_next = panel_chain(k + 1, la)
                    if obs.metrics_active():
                        n_row, n_col = chain_comm_counts(k + 1)
                        cc.record_overlapped("cholesky_dist", ROW_AXIS, n_row)
                        cc.record_overlapped("cholesky_dist", COL_AXIS, n_col)
            else:
                with obs.named_span("cholesky.step%03d.panel", k):
                    ch = panel_chain(k, la)
                with obs.named_span("cholesky.step%03d.strip", k):
                    la = step_pre(k, ch)
            with obs.named_span("cholesky.step%03d.bulk", k):
                step_bulk(k, ch, la is not None)
    return _dist_info(lts, ctx, n) if with_info else None


def _dist_info(lts, ctx: DistContext, n: int):
    """Info of a distributed factor (reference ``_dist_factor_info``): each
    rank's owner-masked bad-column vector, merged by an all-reduce max
    over both grid axes; every rank then holds the same vector."""
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=cc.local_value(lts).device)
    vec = cc.per_rank(ctx.P, ctx.Q, lambda r, c: hinfo.dist_diag_bad(
        lts[r][c], ctx.rr(r), ctx.rc(c), Pr=ctx.P, Qc=ctx.Q, nt=ctx.nt.row, mb=ctx.mb, n=n))
    vec = cc.all_reduce(cc.all_reduce(vec, ROW_AXIS, "max"), COL_AXIS, "max")
    return hinfo.first_bad_info(cc.local_value(vec) > 0)


def _cholesky_dist_scan(lts: cc.Shards, dist, *, uplo, use_mxu=False, use_mixed=False,
                        use_oz_pallas=False, lookahead=False, with_info=False,
                        panel_fused=False, step_fused=False):
    """The scan form of the distributed factorization, IN PLACE on the
    per-rank shards ``lts[r][c]``; returns the info tensor with
    ``with_info``, else None.

    The reference's uniform step body (``_build_dist_cholesky_scan``):
    every step factors the diagonal tile on every rank, solves the panel
    over ALL local slots of the telescoped window and updates the
    ALL-pairs trailing grid of the window under validity masks (about 2x
    the panel work and 3x the trailing flops of the unrolled schedule).
    The reference scans that body with ``lax.scan`` to compile O(1)
    programs; here it is a Python loop over the same windows
    (:func:`..types.telescope_windows`), shapes and masks, so the same
    products are formed. Each kernel launches once per rank per step, the
    last step included.

    Routes, as the reference's gates: the float32 update kernel is
    unrolled-only, so the bulk is the masked all-pairs ``torch.matmul``
    product; ``use_oz_pallas`` runs the predicated pair kernel with the
    step's mode table as data; ``step_fused`` defers the potrf into the
    fused factor+solve kernel at the panel site, ``panel_fused`` runs the
    potrf and solve kernels; ``use_mixed`` the mixed factor and inverse.
    ``lookahead`` carries the panel pair of step k-1 and applies its bulk
    product in step k, after step k's panel, with the next column (row)
    updated eagerly; the pending pair crosses windows (the slots a window
    drops are zero). The factor is bitwise the same with lookahead and
    with_info on or off."""
    ctx = DistContext(dist)
    nt, mb, n = ctx.nt.row, ctx.mb, dist.size.row
    P, Q, ltr, ltc = ctx.P, ctx.Q, ctx.ltr, ctx.ltc
    other = "U" if uplo == "L" else "L"
    lower = uplo == "L"
    fuse_step = step_fused and not use_mixed

    def ranks(fn):
        return cc.per_rank(P, Q, fn)

    def valid(g, k):
        return (g > k) & (g < nt)

    def pair_modes(rv, cv, gr, gc):
        """(R, C) mode table: 1 a pair strictly inside the stored triangle,
        2 (uplo 'L') / 3 ('U') a diagonal pair, 0 elsewhere."""
        pair = rv[:, None] & cv[None, :]
        ondiag = pair & (gr[:, None] == gc[None, :])
        strict = pair & ((gr[:, None] > gc[None, :]) if lower else (gr[:, None] < gc[None, :]))
        return strict.astype(np.int32) + (2 if lower else 3) * ondiag.astype(np.int32)

    def sub_pairs(block, xr, xc, modes):
        """``block -= mask(pair products)``: the (R, C) products of the row
        tiles ``xr`` and the (transposed) column tiles ``xc``."""
        R, C = xr.shape[0], xc.shape[0]
        mode = to_device(modes, block.device, torch.int32)
        if lower:
            afl, bfl = xr.reshape(R * mb, mb), xc.conj().reshape(C * mb, mb)
        else:
            afl, bfl = xr.conj().mT.reshape(R * mb, mb), xc.mT.reshape(C * mb, mb)
        if use_mxu and use_oz_pallas:
            upd = _masked_oz_update(afl, bfl, mode, R, C, mb)
        else:
            full = ds.oz_product(afl, bfl.mT) if use_mxu else afl @ bfl.mT
            upd = full.reshape(R, mb, C, mb).permute(0, 2, 1, 3)
        ds.sub_masked_pairs(block, upd, mode, uplo)

    def panel_site(subs, k, lu_r0, lu_c0, g_rows, g_cols):
        """The diagonal tile on every rank, its factor, the panel over
        every local slot of the window (masked, written back on the owner
        column (row)), broadcast and transposed. Returns the window's row
        and column panel tiles."""
        owner_r, owner_c = ctx.owner_r(k), ctx.owner_c(k)
        kr, kc = ctx.kr(k) - lu_r0, ctx.kc(k) - lu_c0
        ts = min(mb, n - k * mb)
        diag = bcast_diag(ctx, subs, k, row_off=lu_r0, col_off=lu_c0)
        diag = ranks(lambda r, c: pad_diag_identity(diag[r][c], ts))
        # the pivot's owner only writes its diagonal tile
        mine = cc.is_local(owner_r, owner_c)
        own = subs[owner_r][owner_c]
        # the stored edge zeros of a short tile, kept by the write-back
        cand = own[kr, kc].clone() if ts < mb and mine else None
        inv = None
        if use_mixed:
            fi = ranks(lambda r, c: mx.potrf_inv_refined(uplo, diag[r][c]))
            lkk = ranks(lambda r, c: fi[r][c][0] + tb.tri_mask(diag[r][c], other, k=-1))
            inv = ranks(lambda r, c: fi[r][c][1])
        elif fuse_step:
            lkk = None
        else:
            lkk = ranks(lambda r, c: pk.potrf(uplo, diag[r][c]) if panel_fused
                        else tl.potrf(uplo, diag[r][c]))

        def write_diag(t):
            # the pivot's owner only: on the other ranks of its column
            # (row) the slot holds another tile, solved or not
            if cand is not None:
                pad = torch.arange(mb, device=t.device) >= ts
                t = torch.where(pad[:, None] | pad[None, :], cand, t)
            own[kr, kc] = t

        if lkk is not None and mine:
            write_diag(lkk[owner_r][owner_c])

        def src(r, c):
            return subs[r][c][:, kc] if lower else subs[r][c][kr, :]

        side = "R" if lower else "L"
        if fuse_step:
            fs = ranks(lambda r, c: pk.factor_solve(uplo, diag[r][c], src(r, c)))
            lkk = ranks(lambda r, c: fs[r][c][0])
            pan = ranks(lambda r, c: fs[r][c][1])
        elif panel_fused:
            pan = ranks(lambda r, c: pk.panel_solve(side, uplo, "C", "N", lkk[r][c], src(r, c)))
        else:
            pan = ranks(lambda r, c: tb.trsm_panel(side, uplo, "C", "N", lkk[r][c], src(r, c),
                                                   inv_a=inv[r][c] if inv is not None else None))
        for r, c in cc.local_ranks(P, Q):
            a, b = ds.valid_range(g_rows[r] if lower else g_cols[c], k, nt)
            pan[r][c][:a].zero_()
            pan[r][c][b:].zero_()
            if (c == owner_c) if lower else (r == owner_r):
                src(r, c)[a:b] = pan[r][c][a:b]
        if fuse_step and mine:
            write_diag(lkk[owner_r][owner_c])
        if lower:
            vr = cc.bcast(pan, COL_AXIS, owner_c)
            vc = transpose_col_to_rows(ctx, vr, lu_r0, ranks(lambda r, c: g_cols[c]))
            for r, c in cc.local_ranks(P, Q):
                a, b = ds.valid_range(g_cols[c], k, nt)
                vc[r][c][:a].zero_()
                vc[r][c][b:].zero_()
            return vr, vc
        vc = cc.bcast(pan, ROW_AXIS, owner_r)
        vr = transpose_row_to_cols(ctx, vc, lu_c0, ranks(lambda r, c: g_rows[r]))
        for r, c in cc.local_ranks(P, Q):
            a, b = ds.valid_range(g_rows[r], k, nt)
            vr[r][c][:a].zero_()
            vr[r][c][b:].zero_()
        return vr, vc

    def strip(subs, k, lu_r0, lu_c0, g_rows, g_cols, vr, vc):
        """The next column (uplo 'L') or row ('U') updated eagerly from
        this step's panel, on the ranks that own it."""
        if lower:
            kc1, c1 = ctx.kc(k + 1) - lu_c0, ctx.owner_c(k + 1)
            for r, c in cc.local_ranks(P, Q):
                if c != c1:
                    continue
                xr = vr[r][c]
                flat = xr.reshape(-1, mb)
                pk1 = vc[r][c][kc1].conj().mT
                upd = (ds.oz_product(flat, pk1) if use_mxu else flat @ pk1).reshape(xr.shape)
                on = np.flatnonzero(g_rows[r] == k + 1)
                diag_slot = int(on[0]) if on.size else None
                a, b = ds.valid_range(g_rows[r], k + 1, nt)
                ds.sub_masked_rows(subs[r][c][:, kc1], upd, (a, b), diag_slot, True)
            return
        kr1, r1 = ctx.kr(k + 1) - lu_r0, ctx.owner_r(k + 1)
        for r, c in cc.local_ranks(P, Q):
            if r != r1:
                continue
            xc = vc[r][c]
            flat = xc.mT.reshape(-1, mb)
            pk1 = vr[r][c][kr1].conj().mT
            upd = ds.oz_product(pk1, flat.mT) if use_mxu else pk1 @ flat.mT
            upd = upd.reshape(mb, xc.shape[0], mb).permute(1, 0, 2)
            on = np.flatnonzero(g_cols[c] == k + 1)
            diag_slot = int(on[0]) if on.size else None
            a, b = ds.valid_range(g_cols[c], k + 1, nt)
            ds.sub_masked_rows(subs[r][c][kr1, :], upd, (a, b), diag_slot, False)

    def scan_step(subs, k, lu_r0, lu_c0, g_rows, g_cols, pend):
        vr, vc = panel_site(subs, k, lu_r0, lu_c0, g_rows, g_cols)
        if not lookahead:
            for r, c in cc.local_ranks(P, Q):
                sub_pairs(subs[r][c], vr[r][c], vc[r][c], pair_modes(
                    valid(g_rows[r], k), valid(g_cols[c], k), g_rows[r], g_cols[c]))
            return pend
        # the deferred bulk of step k-1, less the column (row) k its strip
        # updated
        for r, c in cc.local_ranks(P, Q):
            rv, cv = valid(g_rows[r], k - 1), valid(g_cols[c], k - 1)
            if lower:
                cv &= g_cols[c] != k
            else:
                rv &= g_rows[r] != k
            sub_pairs(subs[r][c], pend[0][r][c], pend[1][r][c],
                      pair_modes(rv, cv, g_rows[r], g_cols[c]))
        if k + 1 < nt:
            strip(subs, k, lu_r0, lu_c0, g_rows, g_cols, vr, vc)
        return vr, vc

    pend = None
    windows = telescope_windows(nt, lambda k0, _len: (uniform_slot_start(k0, P),
                                                      uniform_slot_start(k0, Q)))
    for (lu_r0, lu_c0), k0, seg_len in windows:
        ltr_s, ltc_s = ltr - lu_r0, ltc - lu_c0
        subs = ranks(lambda r, c: lts[r][c][lu_r0:, lu_c0:])
        g_rows = [ctx.g_rows(r, lu_r0, ltr_s) for r in range(P)]
        g_cols = [ctx.g_cols(c, lu_c0, ltc_s) for c in range(Q)]
        if lookahead:
            _count_step_modes("cholesky_dist_scan", seg_len, 0)
            # each step's diagonal bcast2d, panel broadcast and transposed
            # panel run ahead of the deferred bulk of step k-1: two
            # collectives per axis
            cc.record_overlapped("cholesky_dist_scan", ROW_AXIS, 2 * seg_len)
            cc.record_overlapped("cholesky_dist_scan", COL_AXIS, 2 * seg_len)
            if pend is None:
                pend = tuple(ranks(lambda r, c: lts[r][c].new_zeros((cnt, mb, mb)))
                             for cnt in (ltr_s, ltc_s))
            else:
                pend = (ranks(lambda r, c: pend[0][r][c][-ltr_s:]),
                        ranks(lambda r, c: pend[1][r][c][-ltc_s:]))
        else:
            _count_step_modes("cholesky_dist_scan", 0, seg_len)
        for k in range(k0, k0 + seg_len):
            # the step's index-free name, as the reference's scan body
            with obs.named_span("cholesky.scanstep"):
                pend = scan_step(subs, k, lu_r0, lu_c0, g_rows, g_cols, pend)
    return _dist_info(lts, ctx, n) if with_info else None


def _cholesky_distributed(uplo, mat, *, donate, with_info, trailing, lookahead, panel_fused,
                          step_fused):
    """Route and run :func:`_cholesky_dist` (the reference's gates,
    cholesky.py:1889-1935)."""
    dev = mat.device.type
    dtype = mat.dtype
    nb = mat.block_size.row
    scan = trailing == "scan"
    use_mxu = tb.f64_gemm_uses_mxu(dtype, nb, dev)
    use_mixed = tb.trsm_panel_uses_mixed(dtype, dev)
    comm_la = lookahead and config.resolve("comm_lookahead", dev) == "1"
    want_oz_pallas = use_mxu and config.resolve("ozaki_impl", dev) == "pallas"
    use_oz_pallas = want_oz_pallas and dtype == torch.float64 and nb <= ok.MASKED_MB_MAX
    if use_oz_pallas and not route_available("pallas", "ozaki_pallas"):
        # a drill closed the pair kernel: the whole-rectangle Ozaki
        # products run, counted (strict raises)
        use_oz_pallas = False
    elif want_oz_pallas and not use_oz_pallas:
        config.announce_once(("ozaki_pallas", dtype, nb),
                             f"ozaki_impl=pallas does not apply to dtype={dtype} mb={nb} on a "
                             f"grid (needs float64, mb<={ok.MASKED_MB_MAX}); using the "
                             "whole-rectangle Ozaki products")
    shards = mat.storage if donate else [s if s is None else s.clone() for s in mat.storage]
    if donate:
        mat.storage = None
    P, Q = mat.dist.grid_size.row, mat.dist.grid_size.col
    lts = cc.per_rank(P, Q, lambda r, c: shards[r * Q + c])
    kw = dict(uplo=uplo, use_mxu=use_mxu, use_mixed=use_mixed, use_oz_pallas=use_oz_pallas,
              lookahead=lookahead, with_info=with_info, panel_fused=panel_fused,
              step_fused=step_fused)
    if not scan:
        kw.update(use_pallas=uk.supports_update(dtype, dev) and not use_mxu, comm_la=comm_la)
    _, info = obs.telemetry.call("cholesky.dist", _dist_program, lts, mat.dist, scan=scan, **kw)
    res = Matrix(mat.dist, shards, mat.grid)
    return (res, info) if with_info else res


def _dist_program(lts, dist, *, scan, **kw):
    """``(lts, info)`` of :func:`_cholesky_dist` or, with ``scan``,
    :func:`_cholesky_dist_scan` (the update kernel is unrolled-only, and
    the scan body already orders its panel chain ahead of the deferred
    bulk: no ``comm_la``), factoring ``lts`` in place."""
    info = (_cholesky_dist_scan if scan else _cholesky_dist)(lts, dist, **kw)
    return lts, info


def cholesky(uplo: str, mat: Matrix, *, donate: bool = False, with_info: bool = False):
    """Factorize the Hermitian positive-definite ``mat`` in the ``uplo``
    triangle: L L^H (uplo='L') or U^H U (uplo='U'), on ``mat``'s device.

    Local (no grid, or one rank) or distributed over ``mat.grid``, like
    the reference's two overloads. Returns a new Matrix whose ``uplo``
    triangle holds the factor (the other triangle passes through), or
    ``(factor, info)`` with ``with_info``: ``info`` is an int32 device
    tensor, 0 on success or the 1-based first failing column; the factor
    is bitwise the same either way. ``donate=True`` releases ``mat``'s
    storage to the factorization: ``mat`` must not be used afterwards.

    Under ``DLAF_AUTOTUNE`` the call runs under its site's route (op
    ``cholesky``) and, when ``mat`` survives and the cadence is due, the
    factor's Hutchinson residual (``c = 60``) feeds the route table.
    """
    from .. import autotune

    steer = autotune.steering_for_matrix("cholesky", mat)
    if steer is None:
        return _cholesky(uplo, mat, donate=donate, with_info=with_info)
    with steer.applied():
        out = _cholesky(uplo, mat, donate=donate, with_info=with_info)
    if not donate and steer.probe_due:
        from ..obs import accuracy

        res = out[0] if with_info else out
        steer.observe(accuracy.cholesky_residual(uplo, mat, res), c=60.0, of=res,
                      attrs={"entry": "cholesky", "uplo": uplo})
    return out


def _cholesky(uplo: str, mat: Matrix, *, donate: bool, with_info: bool):
    dlaf_assert(uplo in ("L", "U"), f"cholesky: uplo must be 'L' or 'U', got {uplo!r}")
    dlaf_assert(mat.size.row == mat.size.col, "cholesky: matrix must be square")
    dlaf_assert(mat.block_size.row == mat.block_size.col, "cholesky: block must be square")
    dev = mat.device.type
    trailing = config.resolve("cholesky_trailing", dev)
    dlaf_assert(trailing in config.VALID_TRAILING,
                f"cholesky_trailing must be one of {config.VALID_TRAILING}, got {trailing!r}")
    nb = mat.block_size.row
    dtype = mat.dtype
    # the whole-matrix "xla" route has no step structure to pipeline and
    # no panel chain to route
    lookahead = config.resolve("cholesky_lookahead", dev) == "1" and trailing != "xla"
    panel_fused = trailing != "xla" and pk.panel_uses_fused(dtype, nb, dev)
    step_fused = trailing != "xla" and pk.step_uses_fused(dtype, nb, dev)
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    n = mat.size.row
    P, Q = mat.dist.grid_size.row, mat.dist.grid_size.col
    # unfenced (the launches are asynchronous; the miniapp's fenced span
    # carries the GFlop/s); attrs and the reference's flop model are built
    # only when a record is written
    entry = obs.entry_span("cholesky", lambda: dict(
        flops=total_ops(dtype, n ** 3 / 6, n ** 3 / 6), n=n, nb=nb, uplo=uplo,
        dtype=dtype_name(dtype), trailing=trailing, lookahead=int(lookahead),
        comm_lookahead=int(lookahead and config.resolve("comm_lookahead", dev) == "1"),
        panel_impl="fused" if panel_fused else "xla",
        step_impl="fused" if step_fused else "xla", **at_routes.span_attrs(),
        grid=f"{P}x{Q}"))
    with entry:
        return _cholesky_entry(uplo, mat, donate=donate, with_info=with_info, trailing=trailing,
                               lookahead=lookahead, panel_fused=panel_fused,
                               step_fused=step_fused)


def _cholesky_entry(uplo, mat, *, donate, with_info, trailing, lookahead, panel_fused,
                    step_fused):
    if mat.distributed:
        return _cholesky_distributed(uplo, mat, donate=donate, with_info=with_info,
                                     trailing=trailing, lookahead=lookahead,
                                     panel_fused=panel_fused, step_fused=step_fused)
    dev = mat.device.type
    nb = mat.block_size.row
    dtype = mat.dtype
    dist = mat.dist
    a = tiles_to_global(mat.storage, dist)
    if donate:
        mat.storage = None
    if trailing == "scan":
        out = obs.telemetry.call(
            "cholesky.local_scan", _cholesky_local_scan,
            a, uplo=uplo, nb=nb, use_mxu=tb.f64_gemm_uses_mxu(dtype, nb, dev),
            use_mixed=tb.trsm_panel_uses_mixed(dtype, dev), lookahead=lookahead,
            with_info=with_info, panel_fused=panel_fused, step_fused=step_fused)
    else:
        out = obs.telemetry.call(
            "cholesky.local", _cholesky_local, a, uplo=uplo, nb=nb, trailing=trailing,
            lookahead=lookahead, with_info=with_info, panel_fused=panel_fused,
            step_fused=step_fused)
    info = None
    if with_info:
        out, info = out
    res = Matrix(dist, global_to_tiles(out, dist), mat.grid)
    return (res, info) if with_info else res
