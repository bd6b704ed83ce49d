"""Local blocked Cholesky factorization.

Port of the local branch of ``dlaf_tpu/algorithms/cholesky.py``
(``cholesky`` :1733, ``_cholesky`` :1768, ``_cholesky_local`` :105-406,
``_cholesky_local_scan`` :416-699): the right-looking tile algorithm —
potrf on the diagonal block, panel trsm, trailing herk/gemm update — on
one device, on every local route of the reference:

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

The trailing products outside the kernels are ``torch.matmul``, as the
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
from ..tile_ops import mixed as mx
from ..tile_ops import ozaki as oz
from ..tile_ops import panel_kernels as pk
from ..types import ceil_div, telescope_segments

_F64 = (torch.float64, torch.complex128)


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


def _oz_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` on the Ozaki route (complex: the 4-real-product form), the
    lookahead split's strip on the same route as the bulk it was split
    from."""
    mm = oz.matmul_c128 if x.is_complex() else oz.matmul_f64
    return mm(x, y, slices=tb._oz_slices())


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


def _whole_matrix(a: torch.Tensor, uplo: str) -> torch.Tensor:
    """The "xla" route: one library factor of the whole matrix (NaN from
    the first failing column on), the other triangle passed through."""
    if uplo == "L":
        l = tl._chol_lower_nan(torch.tril(a) + torch.tril(a, -1).mH)
        return torch.tril(l) + torch.triu(a, 1)
    l = tl._chol_lower_nan(torch.triu(a) + torch.triu(a, 1).mH)
    return torch.triu(l.mH) + torch.tril(a, -1)


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
                _add_masked(a[k1:, k1:k1 + w], _oz_product(panel, pj) if use_oz
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
                _add_masked(a[k1:k1 + w, k1:], _oz_product(pt[:w], panel) if use_oz
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
                upd = _oz_product(panel, nstrip) if use_mxu else panel @ nstrip
                _add_masked(acc[:, k1:k1 + nb], upd, idx[:, None] >= near[None, :])
            else:
                nstrip = panel[:, k1:k1 + nb].mH
                upd = _oz_product(nstrip, panel) if use_mxu else nstrip @ panel
                _add_masked(acc[k1:k1 + nb, :], upd, near[:, None] <= idx[None, :])
        return panel

    off = 0
    pp = None
    for seg_len in telescope_segments(nt):
        m = (nt - off) * nb
        sub = a[off * nb:, off * nb:]
        if lookahead:
            # the pending panel crosses segments; the rows it drops are zero
            if pp is None:
                shape = (m, nb) if uplo == "L" else (nb, m)
                pp = torch.zeros(shape, dtype=a.dtype, device=a.device)
            else:
                pp = pp[-m:] if uplo == "L" else pp[:, -m:]
            for k in range(seg_len):
                pp = step_la(sub, pp, k, m)
        else:
            for k in range(seg_len):
                step(sub, k, m)
        off += seg_len
    out = a[:n, :n]
    return (out, hinfo.local_factor_info(out)) if with_info else out


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
    dtype = mat.dtype
    # the whole-matrix "xla" route has no step structure to pipeline and
    # no panel chain to route
    lookahead = config.resolve("cholesky_lookahead", dev) == "1" and trailing != "xla"
    panel_fused = trailing != "xla" and pk.panel_uses_fused(dtype, nb, dev)
    step_fused = trailing != "xla" and pk.step_uses_fused(dtype, nb, dev)
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dist = mat.dist
    a = tiles_to_global(mat.storage, dist)
    if donate:
        mat.storage = None
    if trailing == "scan":
        out = _cholesky_local_scan(
            a, uplo=uplo, nb=nb, use_mxu=tb.f64_gemm_uses_mxu(dtype, nb, dev),
            use_mixed=tb.trsm_panel_uses_mixed(dtype, dev), lookahead=lookahead,
            with_info=with_info, panel_fused=panel_fused, step_fused=step_fused)
    else:
        out = _cholesky_local(a, uplo=uplo, nb=nb, trailing=trailing, lookahead=lookahead,
                              with_info=with_info, panel_fused=panel_fused,
                              step_fused=step_fused)
    info = None
    if with_info:
        out, info = out
    res = Matrix(dist, global_to_tiles(out, dist))
    return (res, info) if with_info else res
