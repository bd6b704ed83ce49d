"""Triangular solve and triangular multiply, local and distributed.

Port of ``dlaf_tpu/algorithms/triangular.py`` (reference
``solver/triangular``, ``multiplication/triangular``): all 8 side x uplo x
op combinations with ``diag``, ``alpha``, local and distributed.

* Local (no grid, or one rank): one whole-matrix solve (:func:`..tile_ops.
  blas.trsm`: ``torch.linalg.solve_triangular``, recursive with the
  connecting products on ``f64_gemm``'s route above
  ``blas.TRSM_RECURSE_MIN``), optionally in free-axis chunks
  (``trsm_rhs_chunk``), and one masked product (``blas.trmm``).
* Distributed: the blocked substitution (accumulation) over tile rows or
  columns, with one controller running every rank as in
  :mod:`.cholesky` (or, in the multi-process form, each process its own
  rank): the pivot diagonal tile to every rank
  (:func:`..matrix.panel.bcast_diag`), the pivot panel solved on every
  rank (the strip-solve kernel with ``panel_impl=fused``, else
  ``blas.trsm_panel``, which honours ``f64_trsm="mixed"``), row and column
  panels by broadcast, transposed panels by the all-gather exchange, and
  the per-k bulk one ``blas.contract("rab,cbd->rcad", ...)``. Unrolled or
  scan by ``dist_step_mode`` (:func:`..config.resolve_step_mode`); the
  scan form keeps the reference's uniform masked steps over telescoped
  windows of the swept axis, as a Python loop, and with
  ``cholesky_lookahead`` its pipelined body (bitwise the same).

Records (:mod:`..obs`), as the reference's: the ``triangular_solve`` and
``triangular_multiply`` entry spans with its flop model and attrs
(``triangular.py:836, 891``); on a grid the per-step phases
``trsm.step<k>.panel|bulk`` and ``trmm.step<k>.panel|bulk``, the scan
forms' index-free ``trsm.scanstep``/``trmm.scanstep``, and for the
pipelined scan solve ``dlaf_comm_overlapped_total`` of the pivot chain's
collectives that run ahead of the deferred bulk.

Program telemetry sites (:mod:`..obs.telemetry`): ``triangular_solve.dist``
and ``triangular_multiply.dist``. Under ``DLAF_AUTOTUNE``
(:mod:`..autotune`) ``triangular_solve`` runs under its site's route (op
``trsm``: the distributed pivot chain's ``panel_impl``, and ``f64_trsm``
and the slice count on the Ozaki route) and, when ``b`` survives
(``donate_b=False``), feeds the solve's Hutchinson residual back (the
reference's ``triangular.py:772-842``).

Not ported now: the ``comm_lookahead`` hoist of the scan solve's A-panel
read, which reorders only the emission of identical values: the port's
eager loop reads A once per step either way.
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
from ..matrix.distribution import assert_slot_aligned
from ..matrix.matrix import Matrix
from ..matrix.panel import (DistContext, bcast_diag, col_panel, pad_diag_identity, row_panel,
                            transpose_col_to_rows, transpose_row_to_cols, uniform_slot_start)
from ..matrix.tiling import global_to_tiles, tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops import panel_kernels as pk
from ..types import dtype_name, telescope_windows, total_ops


def _tile_op(t: torch.Tensor, op: str) -> torch.Tensor:
    if op == "N":
        return t
    x = t.mT
    return x.conj() if op == "C" else x


def _keep_slots(t: torch.Tensor, keep: np.ndarray) -> torch.Tensor:
    """Zero the slots (leading index) of ``t`` outside ``keep`` in place,
    one slice per run (the reference's ``where(keep, t, 0)``); returns
    ``t``."""
    idx = np.flatnonzero(~keep)
    for run in np.split(idx, np.flatnonzero(np.diff(idx) != 1) + 1):
        if run.size:
            t[run[0]:run[-1] + 1].zero_()
    return t


# ---------------------------------------------------------------------------
# Local
# ---------------------------------------------------------------------------

def _solve_local(a, b, alpha, *, side, uplo, op, diag):
    """One whole-matrix solve, in free-axis chunks of ``trsm_rhs_chunk``
    columns (rows for side 'R'): the chunks are independent, so the result
    is bitwise the unchunked one."""
    m, n = b.shape
    free, solve_dim = (n, m) if side == "L" else (m, n)
    cw = tb.resolve_chunk_width("trsm_rhs_chunk", b.dtype, solve_dim, free, b.device.type)
    if not cw:
        return tb.trsm(side, uplo, op, diag, a, b, alpha=alpha)
    dim = 1 if side == "L" else 0
    return torch.cat([tb.trsm(side, uplo, op, diag, a, bc, alpha=alpha)
                      for bc in torch.split(b, cw, dim=dim)], dim=dim)


# ---------------------------------------------------------------------------
# Distributed substitution (solve), reference triangular.py:122-528
# ---------------------------------------------------------------------------

def _panel_solve(side, uplo, op, diag, akk, bk, panel_fused):
    """Solve one pivot panel against the diagonal tile: the strip-solve
    kernel (float32/bfloat16) or ``blas.trsm_panel``."""
    if panel_fused:
        return pk.panel_solve(side, uplo, op, diag, akk, bk)
    return tb.trsm_panel(side, uplo, op, diag, akk, bk)


def _a_panel(ctx_a, ltas, k, g, *, left, op, lu, cnt, lq, cnt_q):
    """A's pivot panel on B's swept slots ``lu .. lu+cnt-1`` (global tiles
    ``g``), ``op`` applied, per rank: column k (side 'L') or row k ('R')
    by broadcast, or for op != 'N' the other one through the transposed
    exchange over A's slots ``lq .. lq+cnt_q-1``."""
    if op == "N":
        e = (col_panel(ctx_a, ltas, k, lu=lu, count=cnt) if left
             else row_panel(ctx_a, ltas, k, lu=lu, count=cnt))
    elif left:
        e = transpose_row_to_cols(ctx_a, row_panel(ctx_a, ltas, k, lu=lq, count=cnt_q), lq, g)
    else:
        e = transpose_col_to_rows(ctx_a, col_panel(ctx_a, ltas, k, lu=lq, count=cnt_q), lq, g)
    return cc.per_rank(*cc.grid_shape(e), lambda r, c: _tile_op(e[r][c], op))


def _dist_solve(ltas: cc.Shards, ltbs: cc.Shards, dist_a, dist_b, *, side, uplo, op, diag,
                panel_fused, scan=False, lookahead=False):
    """The distributed solve, IN PLACE on B's per-rank shards (already
    scaled by alpha). Step k solves pivot row (column) k of B on every
    rank, writes it on its owners and subtracts its product with A's
    masked panel from B's slots of the step's window on the swept axis
    (rows for side 'L', columns for 'R'); op != 'N' reads A's panel
    through the transposed exchange over a window of A's other axis.

    Unrolled (reference ``_build_dist_solve``): each step's window is the
    exact range of remaining slots. ``scan`` (``_build_dist_solve_scan``):
    the windows telescope, forward sweeps keeping the live bottom of the
    slot axis, backward ones the live top, and every step of a window
    updates all its slots under the remaining-slot mask. With
    ``lookahead`` (scan only) a step carries the previous step's masked
    panel and solved pivot ``(pe, pxk)``, applies their bulk after its own
    pivot solve and updates the next pivot row (column) eagerly: bitwise
    the serial order."""
    ctx_a, ctx_b = DistContext(dist_a), DistContext(dist_b)
    nt, n, mb = dist_a.nr_tiles.row, dist_a.size.row, dist_a.block_size.row
    P, Q = ctx_b.P, ctx_b.Q
    left = side == "L"
    # does the substitution sweep k upward?
    forward = ((uplo == "L") == (op == "N")) == left
    p_swept, lt_swept = (ctx_b.P, ctx_b.ltr) if left else (ctx_b.Q, ctx_b.ltc)
    q_orth, lt_orth = (ctx_a.Q, ctx_a.ltc) if left else (ctx_a.P, ctx_a.ltr)

    def ranks(fn):
        return cc.per_rank(P, Q, fn)

    def window(pos, _len):
        """Telescoped windows of B's swept slots and of A's transposed
        exchange for steps pos.. of the sweep."""
        if forward:
            lo, loq = uniform_slot_start(pos, p_swept), uniform_slot_start(pos, q_orth)
            win, winq = (lo, lt_swept - lo), (loq, lt_orth - loq)
        else:
            k_hi = nt - 1 - pos
            win = (0, min(lt_swept, uniform_slot_start(k_hi, p_swept) + 1))
            winq = (0, min(lt_orth, uniform_slot_start(k_hi, q_orth) + 1))
        return win, winq if op != "N" else (0, lt_orth)

    def exact(k):
        """The unrolled step's remaining slots."""
        if forward:
            lo = uniform_slot_start(k + 1, p_swept)
            return (lo, lt_swept - lo), (0, lt_orth)
        return (0, min(lt_swept, (k - 1) // p_swept + 1) if k else 0), (0, lt_orth)

    def slot(t, i):
        """Swept-axis slot ``i`` of a shard or window (a view)."""
        return t[i] if left else t[:, i]

    def bulk(e, x):
        # A's panel as the first operand on both sides, so that a strip's
        # product below is a row block of this one (the same sums in the
        # same order)
        return tb.contract("rab,cbd->rcad", e, x) if left else tb.contract("cbd,rab->rcad", e, x)

    order = range(nt) if forward else range(nt - 1, -1, -1)
    if scan:
        steps = [(win, winq, order[i]) for (win, winq), i0, seg_len
                 in telescope_windows(nt, window) for i in range(i0, i0 + seg_len)]
    else:
        steps = [(*exact(k), k) for k in order]

    def pivot(k):
        """Step k's pivot row (column) of B solved and written on its owners."""
        akk = bcast_diag(ctx_a, ltas, k)
        akk = ranks(lambda r, c: pad_diag_identity(akk[r][c], min(mb, n - k * mb)))
        if left:
            bk, own, piv = row_panel(ctx_b, ltbs, k), ctx_b.owner_r(k), ctx_b.kr(k)
        else:
            bk, own, piv = col_panel(ctx_b, ltbs, k), ctx_b.owner_c(k), ctx_b.kc(k)
        xk = ranks(lambda r, c: _panel_solve(side, uplo, op, diag, akk[r][c], bk[r][c],
                                             panel_fused))
        for r, c in cc.local_ranks(P, Q):
            if (r if left else c) == own:
                slot(ltbs[r][c], piv)[...] = xk[r][c]
        return xk

    def rest(k, xk, lu, cnt, lq, cnt_q, pe, pxk, prev_lu):
        """The bulk of step k; returns the carried (pe, pxk, prev_lu)."""
        g = ranks(lambda r, c: ctx_b.g_rows(r, lu, cnt) if left else ctx_b.g_cols(c, lu, cnt))
        e = _a_panel(ctx_a, ltas, k, g, left=left, op=op, lu=lu, cnt=cnt, lq=lq, cnt_q=cnt_q)
        rem = ranks(lambda r, c: ((g[r][c] > k) if forward else (g[r][c] < k)) & (g[r][c] < nt))
        e = ranks(lambda r, c: _keep_slots(e[r][c], rem[r][c]))
        subs = ranks(lambda r, c: ltbs[r][c][lu:lu + cnt] if left
                     else ltbs[r][c][:, lu:lu + cnt])
        if not lookahead:
            for r, c in cc.local_ranks(P, Q):
                subs[r][c].sub_(bulk(e[r][c], xk[r][c]))
            return pe, pxk, prev_lu
        if pe is None:
            # the pending pair of the step before the first: zero
            pe = ranks(lambda r, c: ltbs[r][c].new_zeros((cnt, mb, mb)))
            pxk = ranks(lambda r, c: torch.zeros_like(xk[r][c]))
        elif lu != prev_lu or cnt != cc.local_value(pe).shape[0]:
            # the window moved: the slots it drops are zero in pe
            d = lu - prev_lu
            pe = ranks(lambda r, c: pe[r][c][d:d + cnt])
        prev_lu = lu
        knext = k + 1 if forward else k - 1
        for r, c in cc.local_ranks(P, Q):
            # the deferred bulk of the previous step, then the next
            # pivot's strip from this one
            subs[r][c].sub_(bulk(pe[r][c], pxk[r][c]))
            nxt = (ctx_b.kr(knext) if left else ctx_b.kc(knext)) - lu
            if 0 <= knext < nt and 0 <= nxt < cnt and g[r][c][nxt] == knext:
                er = e[r][c][nxt]
                upd = (tb.contract("ab,cbd->cad", er, xk[r][c]) if left
                       else tb.contract("bd,rab->rad", er, xk[r][c]))
                slot(subs[r][c], nxt).sub_(upd)
            # the pending panel: this one less the strip's slot
            _keep_slots(e[r][c], rem[r][c] & (g[r][c] != knext))
        return e, xk, prev_lu

    pe = pxk = None
    prev_lu = 0
    for (lu, cnt), (lq, cnt_q), k in steps:
        if lookahead:
            # the bcast2d and the pivot panel's broadcast of each pipelined
            # step run ahead of the previous step's deferred bulk
            cc.record_overlapped("triangular_solve_scan", ROW_AXIS, 1 + left)
            cc.record_overlapped("triangular_solve_scan", COL_AXIS, 1 + (not left))
        with (obs.named_span("trsm.scanstep") if scan
              else obs.named_span("trsm.step%03d.panel", k)):
            xk = pivot(k)
            if cnt <= 0:
                continue
            if scan:
                pe, pxk, prev_lu = rest(k, xk, lu, cnt, lq, cnt_q, pe, pxk, prev_lu)
                continue
        with obs.named_span("trsm.step%03d.bulk", k):
            pe, pxk, prev_lu = rest(k, xk, lu, cnt, lq, cnt_q, pe, pxk, prev_lu)


# ---------------------------------------------------------------------------
# Distributed accumulation (multiply), reference triangular.py:531-712
# ---------------------------------------------------------------------------

def _unit_diag(t: torch.Tensor, diag: str) -> torch.Tensor:
    if diag != "U":
        return t
    eye = torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    return t - torch.diagonal(t, dim1=-2, dim2=-1)[..., None] * eye + eye


def _mask_tri_panel(e, g, k, nt, strict, uplo, op, diag):
    """A pivot panel of the multiply, in place: the diagonal slot's tile
    masked to its (unit) triangle, the strictly included slots whole,
    zero elsewhere."""
    ondiag = g == k
    _keep_slots(e, ondiag | (strict & (g < nt)))
    for j in np.flatnonzero(ondiag):
        tri = uplo if op == "N" else ("U" if uplo == "L" else "L")
        e[j] = _unit_diag(tb.tri_mask(e[j], tri), diag)
    return e


def _mult_panels(ctx_a, ctx_b, ltas, ltbs, k, *, side, uplo, op, diag, lu, cnt, lq, cnt_q,
                 nt):
    """Step k of the multiply on every rank: B's pivot row (column) and
    A's masked pivot panel on B's output slots ``lu .. lu+cnt-1``."""
    P, Q = ctx_b.P, ctx_b.Q
    left = side == "L"
    eff_lower = (uplo == "L") == (op == "N")
    bk = row_panel(ctx_b, ltbs, k) if left else col_panel(ctx_b, ltbs, k)
    g = cc.per_rank(P, Q, lambda r, c: ctx_b.g_rows(r, lu, cnt) if left
                    else ctx_b.g_cols(c, lu, cnt))
    e = _a_panel(ctx_a, ltas, k, g, left=left, op=op, lu=lu, cnt=cnt, lq=lq, cnt_q=cnt_q)
    strict_above = eff_lower if left else not eff_lower

    def one(r, c):
        gg = g[r][c]
        strict = (gg > k) if strict_above else (gg < k)
        return _mask_tri_panel(e[r][c], gg, k, nt, strict, uplo, op, diag)

    return bk, cc.per_rank(P, Q, one)


def _dist_mult(ltas: cc.Shards, ltbs: cc.Shards, dist_a, dist_b, *, side, uplo, op, diag, scan):
    """The distributed multiply; returns the new per-rank shards of
    ``op(A) B`` (``B op(A)``), unscaled. Reference ``_build_dist_mult``
    (unrolled: step k accumulates into the exact reachable window of the
    output) and ``_build_dist_mult_scan`` (``scan``: telescoped windows,
    every step over the whole window, k ascending in both)."""
    ctx_a, ctx_b = DistContext(dist_a), DistContext(dist_b)
    nt = dist_a.nr_tiles.row
    P, Q = ctx_b.P, ctx_b.Q
    eff_lower = (uplo == "L") == (op == "N")
    ascending = eff_lower if side == "L" else not eff_lower
    left = side == "L"
    p_out, lt_out = (ctx_b.P, ctx_b.ltr) if left else (ctx_b.Q, ctx_b.ltc)
    q_orth, lt_orth = (ctx_a.Q, ctx_a.ltc) if left else (ctx_a.P, ctx_a.ltr)
    out = cc.per_rank(P, Q, lambda r, c: torch.zeros_like(ltbs[r][c]))

    def window(k0, seg_len):
        """Output slots (and A's transpose-exchange slots) that steps
        k0 .. k0+seg_len-1 reach."""
        if ascending:
            lo, loq = uniform_slot_start(k0, p_out), uniform_slot_start(k0, q_orth)
            win, winq = (lo, lt_out - lo), (loq, lt_orth - loq)
        else:
            k_hi = k0 + seg_len - 1
            win = (0, min(lt_out, uniform_slot_start(k_hi, p_out) + 1))
            winq = (0, min(lt_orth, uniform_slot_start(k_hi, q_orth) + 1))
        return win, winq if op != "N" else (0, lt_orth)

    if scan:
        steps = [(win, k) for win, k0, seg_len in telescope_windows(nt, window)
                 for k in range(k0, k0 + seg_len)]
    else:
        steps = [(window(k, 1), k) for k in range(nt)]
    for ((lu, cnt), (lq, cnt_q)), k in steps:
        if cnt <= 0:
            continue
        with (obs.named_span("trmm.scanstep") if scan
              else obs.named_span("trmm.step%03d.panel", k)):
            bk, e = _mult_panels(ctx_a, ctx_b, ltas, ltbs, k, side=side, uplo=uplo, op=op,
                                 diag=diag, lu=lu, cnt=cnt, lq=lq, cnt_q=cnt_q, nt=nt)
        with obs.NOOP_CTX if scan else obs.named_span("trmm.step%03d.bulk", k):
            for r, c in cc.local_ranks(P, Q):
                if left:
                    out[r][c][lu:lu + cnt].add_(tb.contract("rab,cbd->rcad", e[r][c],
                                                            bk[r][c]))
                else:
                    out[r][c][:, lu:lu + cnt].add_(tb.contract("rab,cbd->rcad", bk[r][c],
                                                               e[r][c]))
    return out


# ---------------------------------------------------------------------------
# Public API (reference solver/triangular.h, multiplication/triangular.h)
# ---------------------------------------------------------------------------

def _check_args(side, uplo, op, diag, a: Matrix, b: Matrix):
    dlaf_assert(side in ("L", "R") and uplo in ("L", "U") and op in ("N", "T", "C")
                and diag in ("N", "U"), f"triangular: bad side/uplo/op/diag "
                f"{side!r}/{uplo!r}/{op!r}/{diag!r}")
    dlaf_assert(a.size.row == a.size.col, "triangular: A must be square")
    need = b.size.row if side == "L" else b.size.col
    dlaf_assert(a.size.row == need, f"triangular: A size {a.size} vs B {b.size}")
    dlaf_assert(a.block_size.row == a.block_size.col, "A block must be square")
    k = b.block_size.row if side == "L" else b.block_size.col
    dlaf_assert(a.block_size.row == k, "A/B block sizes must agree")


def _grid_shards(mat: Matrix, copy: bool):
    """The per-rank shards of ``mat`` as a nested list (copies with
    ``copy``)."""
    Q = mat.dist.grid_size.col
    shards = ([s if s is None else s.clone() for s in mat.storage] if copy
              else list(mat.storage))
    return cc.per_rank(mat.dist.grid_size.row, Q, lambda r, c: shards[r * Q + c]), shards


def triangular_solve(side: str, uplo: str, op: str, diag: str, alpha, a: Matrix, b: Matrix,
                     *, donate_b: bool = False, with_info: bool = False):
    """``X: op(A) X = alpha B`` (side 'L') or ``X op(A) = alpha B`` ('R'),
    with the ``uplo`` triangle of ``a`` (unit diagonal for ``diag='U'``),
    on ``b``'s device(s). Returns a new Matrix in ``b``'s layout.

    ``donate_b=True`` releases ``b``'s storage to the solve (``b`` must
    not be used afterwards); otherwise neither ``a`` nor ``b`` is written.
    ``with_info=True`` returns ``(X, info)``: an int32 device tensor, 0
    when every diagonal entry of ``A`` is finite and nonzero, else the
    1-based first singular global column; 0 for ``diag='U'``.

    Under ``DLAF_AUTOTUNE`` the call runs under its site's route (op
    ``trsm``) and, when ``b`` survives and the cadence is due, the solve's
    Hutchinson residual (``c = 60``) feeds the route table."""
    from .. import autotune

    steer = autotune.steering_for_matrix("trsm", a)
    if steer is None:
        return _triangular_solve_entry(side, uplo, op, diag, alpha, a, b, donate_b=donate_b,
                                       with_info=with_info)
    with steer.applied():
        out = _triangular_solve_entry(side, uplo, op, diag, alpha, a, b, donate_b=donate_b,
                                      with_info=with_info)
    if not donate_b and steer.probe_due:
        from ..obs import accuracy

        res = out[0] if with_info else out
        steer.observe(accuracy.trsm_residual(side, uplo, op, diag, alpha, a, b, res), c=60.0,
                      of=res, attrs={"entry": "triangular_solve",
                                     "combo": f"{side}{uplo}{op}{diag}"})
    return out


def _triangular_solve_entry(side, uplo, op, diag, alpha, a, b, *, donate_b, with_info):
    _check_args(side, uplo, op, diag, a, b)
    dev = a.device.type
    panel_fused = a.distributed and pk.panel_uses_fused(a.dtype, a.block_size.row, dev)
    with _entry_span("triangular_solve", side, uplo, op, diag, a, b,
                     panel_impl="fused" if panel_fused else "xla", **at_routes.span_attrs()):
        return _triangular_solve(side, uplo, op, diag, alpha, a, b, donate_b=donate_b,
                                 with_info=with_info, panel_fused=panel_fused)


def _entry_span(name, side, uplo, op, diag, a: Matrix, b: Matrix, **extra):
    """The reference's entry span: its flop model (``m n^2 / 2``
    multiplications and additions, n = A's order) and attrs."""
    def attrs():
        sdim = a.size.row
        free = b.size.col if side == "L" else b.size.row
        return dict(flops=total_ops(b.dtype, free * sdim ** 2 / 2, free * sdim ** 2 / 2),
                    side=side, uplo=uplo, op=op, diag=diag, m=b.size.row, n=b.size.col,
                    nb=b.block_size.row, dtype=dtype_name(b.dtype), **extra,
                    grid=f"{b.dist.grid_size.row}x{b.dist.grid_size.col}")

    return obs.entry_span(name, attrs)


def _triangular_solve(side, uplo, op, diag, alpha, a, b, *, donate_b, with_info, panel_fused):
    info = None
    if with_info:
        info = (torch.zeros((), dtype=torch.int32, device=a.device) if diag == "U"
                else hinfo.matrix_diag_info(a, singular=True))
    dev = a.device.type
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if not a.distributed:
        bm = tiles_to_global(b.storage, b.dist)
        if donate_b:
            b.storage = None
        out = _solve_local(tiles_to_global(a.storage, a.dist), bm, alpha, side=side, uplo=uplo,
                           op=op, diag=diag)
        res = Matrix(b.dist, global_to_tiles(out, b.dist), b.grid)
        return (res, info) if with_info else res
    # per-slot panels of A meet per-slot tiles of B on the swept axis
    assert_slot_aligned(a.dist, b.dist, rows=side == "L", cols=side == "R",
                        what="triangular_solve(A, B)")
    ltbs, shards = _grid_shards(b, copy=False)
    if donate_b:
        b.storage = None
        for s in shards:
            if s is not None:
                s.mul_(alpha)
    else:
        ltbs = cc.per_rank(len(ltbs), len(ltbs[0]), lambda r, c: alpha * ltbs[r][c])
        shards = [x for row in ltbs for x in row]
    ltas, _ = _grid_shards(a, copy=False)
    kw = dict(side=side, uplo=uplo, op=op, diag=diag, panel_fused=panel_fused)
    scan = config.resolve_step_mode(a.dist.nr_tiles.row, dev) == "scan"
    obs.telemetry.call("triangular_solve.dist", _solve_program, ltas, ltbs, a.dist, b.dist,
                       scan=scan,
                       lookahead=scan and config.resolve("cholesky_lookahead", dev) == "1", **kw)
    res = Matrix(b.dist, shards, b.grid)
    return (res, info) if with_info else res


def _solve_program(ltas, ltbs, dist_a, dist_b, **kw):
    """:func:`_dist_solve` in place on ``ltbs``, returning them."""
    _dist_solve(ltas, ltbs, dist_a, dist_b, **kw)
    return ltbs


def triangular_multiply(side: str, uplo: str, op: str, diag: str, alpha, a: Matrix,
                        b: Matrix) -> Matrix:
    """``alpha op(A) B`` (side 'L') or ``alpha B op(A)`` ('R') with the
    ``uplo`` triangle of ``a``, as a new Matrix in ``b``'s layout; ``a``
    and ``b`` are not written."""
    _check_args(side, uplo, op, diag, a, b)
    with _entry_span("triangular_multiply", side, uplo, op, diag, a, b):
        return _triangular_multiply(side, uplo, op, diag, alpha, a, b)


def _triangular_multiply(side, uplo, op, diag, alpha, a, b):
    dev = a.device.type
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if not a.distributed:
        out = tb.trmm(side, uplo, op, diag, tiles_to_global(a.storage, a.dist),
                      tiles_to_global(b.storage, b.dist), alpha=alpha)
        return Matrix(b.dist, global_to_tiles(out, b.dist), b.grid)
    assert_slot_aligned(a.dist, b.dist, rows=side == "L", cols=side == "R",
                        what="triangular_multiply(A, B)")
    ltas, _ = _grid_shards(a, copy=False)
    ltbs, _ = _grid_shards(b, copy=False)
    out = obs.telemetry.call("triangular_multiply.dist", _dist_mult, ltas, ltbs, a.dist,
                             b.dist, side=side, uplo=uplo, op=op, diag=diag,
                             scan=config.resolve_step_mode(a.dist.nr_tiles.row, dev) == "scan")
    return Matrix(b.dist, [x if x is None else x.mul_(alpha) for row in out for x in row],
                  b.grid)
