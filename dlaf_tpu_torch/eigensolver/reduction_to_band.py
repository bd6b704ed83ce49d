"""Reduction of a Hermitian matrix to band form, local and distributed.

Port of ``dlaf_tpu/eigensolver/reduction_to_band.py`` (reference
``eigensolver/reduction_to_band``; band = block size by default, any band
dividing the block size, distributed included). Per panel of ``b`` columns:

* the panel's reflectors by ONE ``panel_qr`` (``torch.geqrf``: LAPACK on
  the CPU, cuSOLVER on the card) and the compact-WY T factor by ``larft``;
* the two-sided trailing update as three products: ``W = A (V T)``, ``M =
  V^H W``, ``X = W - 1/2 V (T^H M)``, then ``A <- A - X V^H - V X^H``. The
  products of A go through ``blas.mm``/``blas.contract``, so they follow
  ``f64_gemm`` (the Ozaki slice kernel #6 under "mxu"); ``v @ t`` and
  ``t^H @ m`` stay plain ``@``, as in the reference.

The trailing matrix is kept full Hermitian during the sweep; on return the
matrix holds the band (diagonal blocks and the upper-triangular R blocks
below them), the reflectors V below the band (LAPACK style), and the taus
``(ceil(n/b) - 1, b)``, zero-padded: what the band-to-tridiagonal chase and
the back-transform read.

Four builders, after the reference's: :func:`_red2band_local` (unrolled,
in place on one global tensor), :func:`_red2band_local_scan` (uniform
masked steps over telescoped segments), :func:`_red2band_dist` (one
controller running every rank of the grid per step, the panel gathered and
factored for every rank, W/M/X by partial products and all-reduces; with
``comm_lookahead`` the next panel's gather and QR run before this panel's
bulk rank-2 product, bitwise the same) and :func:`_red2band_dist_scan`
(uniform masked steps over telescoped windows). The reference scans its
uniform bodies with ``lax.scan``; here they are Python loops at its
shapes and masks.

The gathered panel is the same value on every rank, so the distributed
builders factor it (with its ``V T``) once per distinct device; likewise
each value of the step that every rank of a grid row, a grid column or
the grid holds alike (V's and X's selections, W, M and X, their sums) is
formed once per line and device. The ranks on that device share the one
result and only read it: bitwise what per-rank forming gives, one
``geqrf`` per device and panel instead of one per rank. With one device
per rank every value is formed on every rank, as in the reference, and so
it is in the multi-process form (:mod:`..comm.multihost`), where each
process forms its own rank's values: the same values, but the launches
summed over processes sharing one card exceed the single controller's on
that card by the sharing it does. The builders run there unchanged (loops
over ``cc.local_ranks``, the owners' writes guarded), and
:func:`extract_band` gathers the band's tiles on the process of rank
(0, 0) only.

Records (:mod:`..obs`): the ``reduction_to_band`` entry span with the
reference's flop model and attrs (``reduction_to_band.py:667``); on a
grid the per-step ``red2band.step<p>.panel|strip|bulk`` phases (the
hoisted next panel named as its own step's), the scan form's
``red2band.scanstep``, and ``dlaf_comm_overlapped_total`` of the panel
gather hoisted by ``comm_lookahead``; the program telemetry sites
``reduction_to_band.local``, ``.local_scan`` and ``.dist``
(:mod:`..obs.telemetry`). The reference's ``route=`` argument is not
needed: an eager call reads the active autotune route as it runs (the
eigensolver applies it around this stage, :mod:`..autotune`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import config, obs
from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..common.index2d import GlobalElementIndex
from ..matrix.matrix import Matrix
from ..matrix.panel import (DistContext, element_valid, gather_col_panel_ordered,
                            gather_sub_panel, gather_sub_panel_dyn, pad_sub_panel_to_tiles,
                            tiles_of_rolled, to_device, uniform_slot_start)
from ..matrix.tiling import global_to_tiles, tiles_to_global
from ..matrix.views import SubMatrixView
from ..tile_ops import blas as tb
from ..tile_ops.lapack import larft
from ..tile_ops.qr_panel import panel_qr
from ..types import ceil_div, dtype_name, telescope_segments, telescope_windows, total_ops


@dataclasses.dataclass
class BandReduction:
    """The band+V matrix, the taus ``(ceil(n/band) - 1, band)`` zero-padded
    (on the device of rank (0, 0); in the multi-process form every process
    holds them, on its rank's device), and the bandwidth ``band``."""

    matrix: Matrix
    taus: torch.Tensor
    band: int


# ---------------------------------------------------------------------------
# Local (reference reduction_to_band.py:77-260)
# ---------------------------------------------------------------------------

def _two_sided(acc: torch.Tensor, w: torch.Tensor, v: torch.Tensor, t: torch.Tensor) -> None:
    """The trailing two-sided update of ``acc`` in place, from ``W = A V
    T`` (A masked as the builder needs): ``M``, ``X`` and ``acc -= X V^H
    + V X^H``."""
    m = tb.mm(v.mH, w)                              # V^H W  (b x b)
    x = w - 0.5 * v @ (t.mH @ m)
    acc -= tb.mm(x, v.mH)
    acc -= tb.mm(v, x.mH)


def _red2band_local(a: torch.Tensor, *, nb: int):
    """Reduce the ``(n, n)`` tensor ``a`` IN PLACE with panels of width
    ``nb`` (the bandwidth, any ``1 <= nb <= n``); returns ``(a, taus)``."""
    n = a.shape[0]
    nt = ceil_div(n, nb) if n else 0
    taus_out = a.new_zeros((max(nt - 1, 0), nb))
    for k in range(nt - 1):
        k0, k1 = k * nb, (k + 1) * nb
        m_p = n - k1
        vfull, taus = panel_qr(a[k1:, k0:k1])
        a[k1:, k0:k1] = vfull                      # R in the upper part, V below
        ntau = taus.shape[0]
        taus_out[k, :ntau] = taus
        v = torch.tril(vfull, -1) + torch.eye(m_p, nb, dtype=a.dtype, device=a.device)
        if ntau < nb:
            taus = torch.cat([taus, taus.new_zeros(nb - ntau)])
        t = larft(v, taus)
        trail = a[k1:, k1:]                        # full Hermitian
        _two_sided(trail, tb.mm(trail, v @ t), v, t)
    return a, taus_out


def _red2band_local_scan(a: torch.Tensor, *, nb: int):
    """The scan form of the local reduction: every step of a telescoped
    segment runs at the segment's uniform size, its panel the whole
    masked column top-aligned by a roll (zero rows below a Householder
    panel leave its reflectors unchanged) and its two-sided update full
    size under masks. A ragged ``n`` is zero-padded (a new tensor),
    otherwise ``a`` is reduced in place; returns ``(a, taus)``."""
    n = a.shape[0]
    if n == 0:
        return a, a.new_zeros((0, nb))
    nt = ceil_div(n, nb)
    npan = nt - 1
    npad = nt * nb - n
    if npad:
        full = a.new_zeros((nt * nb, nt * nb))
        full[:n, :n] = a
        a = full
    taus_out = a.new_zeros((npan, nb))
    dev = a.device

    def step(acc, k, off, m):
        """Panel ``k`` on the trailing window ``acc`` = a[off*nb:, off*nb:]
        of size ``m``."""
        k0 = (k - off) * nb             # the panel's column in the window
        bdy = k0 + nb
        below = torch.arange(m, device=dev) >= bdy
        raw = acc[:, k0:k0 + nb]
        pan = torch.roll(torch.where(below[:, None], raw, 0.0), -bdy, 0)
        # m >= 2 nb whenever a step runs, so geqrf gives nb taus; the
        # columns past n are masked
        vfull, taus = panel_qr(pan)
        taus = torch.where(torch.arange(nb, device=dev) < n - (k + 1) * nb, taus, 0.0)
        taus_out[k] = taus
        vtop = torch.tril(vfull, -1) + torch.eye(m, nb, dtype=a.dtype, device=dev)
        t = larft(vtop, taus)
        v = torch.where(below[:, None], torch.roll(vtop, bdy, 0), 0.0)
        acc[:, k0:k0 + nb] = torch.where(below[:, None], torch.roll(vfull, bdy, 0), raw)
        both = below[:, None] & below[None, :]
        _two_sided(acc, tb.mm(torch.where(both, acc, 0.0), v @ t), v, t)

    # telescoped segments: each scans the shrinking trailing window
    p_start = 0
    for seg_len in telescope_segments(npan):
        off = p_start
        m = (nt - off) * nb
        sub = a[off * nb:, off * nb:]
        for k in range(p_start, p_start + seg_len):
            step(sub, k, off, m)
        p_start += seg_len
    return a[:n, :n], taus_out


# ---------------------------------------------------------------------------
# Distributed (reference reduction_to_band.py:267-607)
# ---------------------------------------------------------------------------

class _Factor(NamedTuple):
    """One gathered panel factored: geqrf's ``vfull`` and the taus (padded
    to ``b``), the unit lower V and its T factor, and V and ``V T`` cut
    into tile rows."""

    vfull: torch.Tensor
    taus: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    v_tiles: torch.Tensor
    vt_tiles: torch.Tensor


def _factor(pan: torch.Tensor, b: int, live: int, tiles) -> _Factor:
    """Factor one gathered panel: geqrf, the taus padded to ``b`` and zero
    past the ``live`` real reflector columns, V, T, and the tile forms by
    ``tiles``."""
    vfull, taus = panel_qr(pan)
    ntau = taus.shape[0]
    if ntau < b:
        taus = torch.cat([taus, taus.new_zeros(b - ntau)])
    taus = torch.where(torch.arange(b, device=taus.device) < live, taus, 0.0)
    v = torch.tril(vfull, -1) + torch.eye(vfull.shape[0], b, dtype=vfull.dtype,
                                          device=vfull.device)
    t = larft(v, taus)
    return _Factor(vfull, taus, v, t, tiles(v), tiles(v @ t))


def _factor_per_device(pan, b: int, live: int, tiles):
    """:func:`_factor` of the per-rank panels, run once per distinct device
    (the gathered panel is the same value on every rank)."""
    return cc.per_rank_once(*cc.grid_shape(pan), lambda r, c: pan[r][c].device,
                            lambda r, c: _factor(pan[r][c], b, live, tiles))


def _per_row(lts, make):
    """``per_rank`` of ``make`` for a value that depends only on the rank's
    grid row: formed once per row and device of ``lts``' ranks."""
    return cc.per_rank_once(*cc.grid_shape(lts), lambda r, c: (r, lts[r][c].device), make)


def _per_col(lts, make):
    """:func:`_per_row` for a value that depends only on the grid column."""
    return cc.per_rank_once(*cc.grid_shape(lts), lambda r, c: (c, lts[r][c].device), make)


def _masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``where(mask, x, 0)`` with the ``(slots, nb)`` mask broadcast over
    ``x``'s last axis."""
    return torch.where(mask[..., None], x, 0.0)


class _Panel:
    """One panel's index data per rank, on the rank's device: the element
    masks of its row and column slots (elements in ``[bdy, n)``) and their
    tile indices into a panel quantity whose first tile is global tile row
    ``first`` (clipped: slots past the matrix are masked), each put on a
    device once per grid row or column. ``g_cols=None`` gives the row data
    only."""

    def __init__(self, ctx: DistContext, lts, g_rows, g_cols, bdy: int, n: int, first: int):
        self.ctx, self.first = ctx, first

        def sel(g):
            return np.clip(g - first, 0, ctx.nt.row - first - 1)

        def valid(g):
            return element_valid(g, ctx.mb, bdy, n)

        def by_row(make, dtype=torch.int64):
            return _per_row(lts, lambda r, c: to_device(make(g_rows[r]), lts[r][c].device, dtype))

        def by_col(make, dtype=torch.int64):
            return _per_col(lts, lambda r, c: to_device(make(g_cols[c]), lts[r][c].device, dtype))

        self.rmask, self.rsel = by_row(valid, torch.bool), by_row(sel)
        if g_cols is not None:
            self.cmask, self.csel = by_col(valid, torch.bool), by_col(sel)

    def rows(self, x: torch.Tensor, r: int, c: int) -> torch.Tensor:
        """Rank ``(r, c)``'s row slots of the panel quantity ``x``, masked."""
        return _masked(x.index_select(0, self.rsel[r][c]), self.rmask[r][c])

    def cols(self, x: torch.Tensor, r: int, c: int) -> torch.Tensor:
        """Rank ``(r, c)``'s column slots of ``x``, masked."""
        return _masked(x.index_select(0, self.csel[r][c]), self.cmask[r][c])


def _write_panel(lts, pnl: _Panel, fac, tiles, lu: int, kc: int, co: int, b: int, oc: int):
    """The factored panel back to the owner column's rows ``lu ..`` of
    local tile column ``kc``, element columns ``co .. co+b``."""
    for r, c in cc.local_ranks(pnl.ctx.P, pnl.ctx.Q):
        if c != oc:
            continue
        new = tiles(fac[r][c].vfull).index_select(0, pnl.rsel[r][c])
        cur = lts[r][c][lu:, kc, :, co:co + b]
        lts[r][c][lu:, kc, :, co:co + b] = torch.where(pnl.rmask[r][c][..., None], new, cur)


def _wmx(pnl: _Panel, blocks, fac, lu: int):
    """W, M and X of one panel, and the bulk's operands: ``W`` by each
    rank's product of its masked trailing block ``blocks[r][c]`` with the
    masked ``V T`` tiles of its columns, summed along the column axis;
    ``M = V^H W`` by partial products summed along the row axis; ``X = W -
    1/2 V (T^H M)`` gathered in order. Returns per rank ``(xr, vr, xc,
    vc)``: X's and V's tiles of the rank's row slots and of its column
    slots, masked. A value that depends only on the rank's grid row (or
    column) is formed once per row (column) and device."""
    ctx = pnl.ctx

    def w_part(r, c):
        atr = torch.where(pnl.rmask[r][c][:, None, :, None] & pnl.cmask[r][c][None, :, None, :],
                          blocks[r][c], 0.0)
        return tb.contract("rcab,cbd->rad", atr, vtc[r][c])

    vtc = _per_col(blocks, lambda r, c: pnl.cols(fac[r][c].vt_tiles, r, c))
    w = cc.all_reduce(cc.per_rank(ctx.P, ctx.Q, w_part), COL_AXIS, shared=True)  # (rows, nb, b)
    vr = _per_row(blocks, lambda r, c: pnl.rows(fac[r][c].v_tiles, r, c))
    m_part = _per_row(blocks, lambda r, c: tb.contract("rab,rad->bd", vr[r][c].conj(), w[r][c]))
    m = cc.all_reduce(m_part, ROW_AXIS, shared=True)
    x = _per_row(blocks, lambda r, c: w[r][c] - 0.5 * (
        torch.einsum("rab,bd->rad", vr[r][c], fac[r][c].t.mH @ m[r][c])))
    xfull = gather_col_panel_ordered(ctx, x, pnl.first, lu)
    xc = _per_col(blocks, lambda r, c: pnl.cols(xfull[r][c], r, c))
    vc = _per_col(blocks, lambda r, c: pnl.cols(fac[r][c].v_tiles, r, c))
    xr = _per_row(blocks, lambda r, c: _masked(x[r][c], pnl.rmask[r][c]))
    return xr, vr, xc, vc


def _bulk_product(ops, r: int, c: int) -> torch.Tensor:
    """Rank ``(r, c)``'s ``X V^H + V X^H`` over its trailing tile grid."""
    xr, vr, xc, vc = ops
    return (tb.contract("rad,cbd->rcab", xr[r][c], vc[r][c].conj())
            + tb.contract("rad,cbd->rcab", vr[r][c], xc[r][c].conj()))


def _red2band_dist(lts: cc.Shards, dist, band: int, *, comm_la: bool = False) -> torch.Tensor:
    """Reduce the distributed matrix whose rank ``(r, c)`` holds
    ``lts[r][c]`` IN PLACE with bandwidth ``band`` (dividing the block
    size); returns the taus.

    Panel ``p`` covers element columns ``[p b, (p+1) b)``, a static slice
    of one tile column, and its boundary ``(p+1) b`` cuts tiles at a
    static in-tile offset, so the reference's tile masks become element
    masks. Per panel, as the reference's ``factor_panel`` /
    ``trailing_ops`` / ``apply_bulk``: the sub-panel gathered on every
    rank, factored (once per device), written back by the owner column;
    W, M and X (:func:`_wmx`); the bulk ``A -= X V^H + V X^H`` over each
    rank's trailing tile grid.

    ``comm_la``: once X is formed, the next panel's element columns take
    their rank-2 update eagerly, the next panel is gathered, factored and
    written back, and only then the bulk runs, without those columns. The
    reference takes that strip from one narrow product, whose cells its
    CPU backend sums as the bulk's; a BLAS need not (MKL's complex
    product of one tile column does not), so here the owner column's
    whole bulk product is formed early and the strip cut from it: bitwise
    the same result with the knob on or off, the same products."""
    ctx = DistContext(dist)
    nt, nb, n = ctx.nt.row, ctx.mb, dist.size.row
    P, Q = ctx.P, ctx.Q
    b = band
    npan = ceil_div(n, b) - 1 if n else 0
    taus_out = cc.local_value(lts).new_zeros((max(npan, 0), b))

    def indices(p):
        """The boundary, its tile row and in-tile row, and the first row
        and column slots of panel ``p``'s trailing block."""
        bdy = (p + 1) * b
        body = SubMatrixView(dist, GlobalElementIndex(bdy, p * b))
        tr0, ro = body.begin_tile.row, body.origin_in_tile.row
        return bdy, tr0, ro, ctx.row_start(tr0), ctx.col_start(tr0)

    def factor_panel(p):
        """Gather, factor and write back panel ``p``; the per-rank factors,
        or None when no rank has a row below the boundary."""
        bdy = (p + 1) * b
        got = gather_sub_panel(ctx, lts, pb=p * b, b=b, n=n)
        if got is None:
            return None
        pan, lu, tr0, ro, _, g_rows = got

        def tiles(x):
            return pad_sub_panel_to_tiles(ctx, x, tr0=tr0, ro=ro)

        fac = _factor_per_device(pan, b, n - bdy, tiles)
        taus_out[p] = cc.local_value(fac).taus.to(taus_out.device)
        tc = (p * b) // nb
        _write_panel(lts, _Panel(ctx, lts, g_rows, None, bdy, n, tr0), fac, tiles, lu,
                     ctx.kc(tc), (p * b) % nb, b, ctx.owner_c(tc))
        return fac

    def trailing_ops(p, fac, strip_next):
        """Panel ``p``'s update up to the bulk: W, M and X and, with
        ``strip_next``, the eager strip of the next panel's columns.
        Returns the bulk's operands, or None when a rank has no trailing
        slot."""
        bdy, tr0, ro, lu, luc = indices(p)
        nrows, ncols = ctx.ltr - lu, ctx.ltc - luc
        if ncols == 0 or nrows == 0:
            return None
        pnl = _Panel(ctx, lts, [ctx.g_rows(r, lu, nrows) for r in range(P)],
                     [ctx.g_cols(c, luc, ncols) for c in range(Q)], bdy, n, tr0)
        ops = _wmx(pnl, cc.per_rank(P, Q, lambda r, c: lts[r][c][lu:, luc:]), fac, lu)
        early = None
        if strip_next:
            # the next panel's element columns [bdy, bdy + b), taken from
            # their owners' bulk product (computed here, applied in the
            # bulk without them) before that panel's gather
            tc1, co1 = bdy // nb, bdy % nb
            own1, idx1 = ctx.owner_c(tc1), ctx.kc(tc1) - luc
            early = (own1, {})
            for r, c in cc.local_ranks(P, Q):
                if c != own1:
                    continue
                upd = _bulk_product(ops, r, own1)
                strip = upd[:, idx1, :, co1:co1 + b]
                lts[r][own1][lu:, luc + idx1, :, co1:co1 + b] -= strip
                strip.zero_()
                early[1][r] = upd
        return lu, luc, ops, early

    def apply_bulk(step):
        """``A -= X V^H + V X^H`` over every rank's trailing tile grid; the
        owner column of an eager strip takes its product formed there, the
        stripped columns zeroed."""
        lu, luc, ops, early = step
        for r, c in cc.local_ranks(P, Q):
            upd = (early[1].pop(r) if early is not None and c == early[0]
                   else _bulk_product(ops, r, c))
            lts[r][c][lu:, luc:] -= upd
            del upd

    fac = None
    for p in range(npan):
        if not comm_la:
            with obs.named_span("red2band.step%03d.panel", p):
                fac = factor_panel(p)
            if fac is None:
                continue
            with obs.named_span("red2band.step%03d.strip", p):
                step = trailing_ops(p, fac, False)
            if step is not None:
                with obs.named_span("red2band.step%03d.bulk", p):
                    apply_bulk(step)
            continue
        if fac is None:
            with obs.named_span("red2band.step%03d.panel", p):
                fac = factor_panel(p)
        if fac is None:
            continue
        strip_next = p + 1 < npan
        with obs.named_span("red2band.step%03d.strip", p):
            step = trailing_ops(p, fac, strip_next)
        fac = None
        if step is None:
            continue
        if strip_next:
            # panel p+1's gather, QR and write-back before panel p's bulk
            with obs.named_span("red2band.step%03d.panel", p + 1):
                fac = factor_panel(p + 1)
            if fac is not None:
                cc.record_overlapped("red2band_dist", ROW_AXIS, 1)
                cc.record_overlapped("red2band_dist", COL_AXIS, 1)
        with obs.named_span("red2band.step%03d.bulk", p):
            apply_bulk(step)
    return taus_out


def _red2band_dist_scan(lts: cc.Shards, dist, band: int) -> torch.Tensor:
    """The scan form of the distributed reduction, IN PLACE on
    ``lts[r][c]``; returns the taus. Every step of a telescoped window runs
    at the window's uniform shapes: the window-height masked panel column
    gathered and top-aligned by a roll, factored, rolled back into tile
    rows, and the two-sided update over all the window's slots under
    element masks (the reference's ``_build_dist_red2band_scan``)."""
    ctx = DistContext(dist)
    nt, nb, n = ctx.nt.row, ctx.mb, dist.size.row
    P, Q = ctx.P, ctx.Q
    b = band
    npan = ceil_div(n, b) - 1 if n else 0
    taus_out = cc.local_value(lts).new_zeros((max(npan, 0), b))
    if npan <= 0:
        return taus_out

    def step(subs, p, lu_off, lc_off):
        base = lu_off * P                # the window's first global tile row
        pan, bdy, tc, co, _, g_rows, raw = gather_sub_panel_dyn(
            ctx, subs, p=p, b=b, n=n, row_off=lu_off, col_off=lc_off)

        def tiles(x):
            return tiles_of_rolled(ctx, x, bdy, base * nb)

        fac = _factor_per_device(pan, b, n - bdy, tiles)
        taus_out[p] = cc.local_value(fac).taus.to(taus_out.device)
        # window slots past the last tile row or column are masked; the
        # clip keeps their indices in range
        pnl = _Panel(ctx, subs, g_rows,
                     [ctx.g_cols(c, lc_off, ctx.ltc - lc_off) for c in range(Q)], bdy, n, base)
        _write_panel(subs, pnl, fac, tiles, 0, ctx.kc(tc) - lc_off, co, b, ctx.owner_c(tc))
        ops = _wmx(pnl, subs, fac, lu_off)
        for r, c in cc.local_ranks(P, Q):
            upd = _bulk_product(ops, r, c)
            subs[r][c] -= upd
            del upd

    def window(pos, _seg_len):
        t_min = (pos * b) // nb
        return uniform_slot_start(t_min, P), uniform_slot_start(t_min, Q)

    for (lu_off, lc_off), p0, seg_len in telescope_windows(npan, window):
        subs = cc.per_rank(P, Q, lambda r, c: lts[r][c][lu_off:, lc_off:])
        for p in range(p0, p0 + seg_len):
            with obs.named_span("red2band.scanstep"):
                step(subs, p, lu_off, lc_off)
    return taus_out


# ---------------------------------------------------------------------------
# Public API (reference eigensolver/reduction_to_band.h)
# ---------------------------------------------------------------------------

def reduction_to_band(a: Matrix, band_size: int | None = None, *,
                      donate: bool = False) -> BandReduction:
    """Reduce the Hermitian ``a`` (FULL storage: both triangles) to band
    form on ``a``'s device(s).

    ``band_size`` (default: the block size) is the bandwidth; it must divide
    the block size (reference ``reduction_to_band.h:84``), local and
    distributed. The step form follows ``dist_step_mode``, "auto" picking
    scan from ``STEP_MODE_AUTO_SCAN_AT`` panels. ``donate=True`` releases
    ``a``'s storage to the reduction (the reference's in-place semantics):
    ``a`` must not be used afterwards; with ``donate=False`` its storage is
    left as it was."""
    dlaf_assert(a.size.row == a.size.col, "reduction_to_band: square only")
    dlaf_assert(a.block_size.row == a.block_size.col, "square blocks only")
    nb = a.block_size.row
    band = nb if band_size is None else band_size
    dlaf_assert(band >= 1, f"reduction_to_band: band_size must be >= 1, got {band}")
    dlaf_assert(nb % band == 0,
                f"reduction_to_band: block size {nb} not divisible by band_size {band}"
                " (reference reduction_to_band.h:84)")
    n = a.size.row
    # the reference's flop model (miniapp_reduction_to_band): 2n^3/3
    # multiplications and additions
    span = obs.entry_span("reduction_to_band", lambda: dict(
        flops=total_ops(a.dtype, 2 * n ** 3 / 3, 2 * n ** 3 / 3), n=n, nb=nb, band=band,
        dtype=dtype_name(a.dtype), grid=f"{a.dist.grid_size.row}x{a.dist.grid_size.col}"))
    with span:
        return _reduction_to_band(a, band, donate)


def _reduction_to_band(a: Matrix, band: int, donate: bool) -> BandReduction:
    nb = a.block_size.row
    dev = a.device.type
    if dev == "cuda":
        # the reference's float32 products are full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    # the step count is the PANEL count: ceil(n/band) - 1 panel steps
    scan = config.resolve_step_mode(max(ceil_div(a.size.row, band) - 1, 1), dev) == "scan"
    if not a.distributed:
        g = tiles_to_global(a.storage, a.dist)
        if donate:
            a.storage = None
        if scan:
            out, taus = obs.telemetry.call("reduction_to_band.local_scan",
                                           _red2band_local_scan, g, nb=band)
        else:
            out, taus = obs.telemetry.call("reduction_to_band.local", _red2band_local, g,
                                           nb=band)
        return BandReduction(Matrix(a.dist, global_to_tiles(out, a.dist), a.grid), taus, band)
    shards = a.storage if donate else [s if s is None else s.clone() for s in a.storage]
    if donate:
        a.storage = None
    P, Q = a.dist.grid_size.row, a.dist.grid_size.col
    lts = cc.per_rank(P, Q, lambda r, c: shards[r * Q + c])
    # the scan body's W reads the whole trailing window every step, so the
    # next panel's gather cannot go ahead of the bulk
    _, taus = obs.telemetry.call("reduction_to_band.dist", _red2band_program, lts, a.dist,
                                 band, scan=scan,
                                 comm_la=not scan
                                 and config.resolve("comm_lookahead", dev) == "1")
    return BandReduction(Matrix(a.dist, shards, a.grid), taus, band)


def _red2band_program(lts, dist, band, *, scan, comm_la):
    """``(lts, taus)`` of the distributed reduction, in place on ``lts``."""
    if scan:
        return lts, _red2band_dist_scan(lts, dist, band)
    return lts, _red2band_dist(lts, dist, band, comm_la=comm_la)


def _band_tiles(mat: Matrix):
    """The diagonal tiles and the first sub-diagonal tiles (a zero tile
    appended), each ``(nt, nb, nb)`` on the device of rank (0, 0): the
    only tiles the band touches, gathered from their owners
    (:func:`..comm.collectives.gather`: in the multi-process form each
    process sends the process of rank (0, 0) the tiles its rank owns, and
    the other processes get None)."""
    dist = mat.dist
    nt = dist.nr_tiles.row
    if not mat.distributed:
        idx = torch.arange(nt, device=mat.device)
        diag = mat.storage[idx, idx]
        sub = mat.storage[idx[1:], idx[:-1]]
        return diag, torch.cat([sub, torch.zeros_like(diag[:1])])
    ctx = DistContext(dist)
    P, Q = ctx.P, ctx.Q
    want = [(i, i) for i in range(nt)] + [(i + 1, i) for i in range(nt - 1)]
    owned = {(r, c): [(i, j) for i, j in want if (ctx.owner_r(i), ctx.owner_c(j)) == (r, c)]
             for r in range(P) for c in range(Q)}

    def mine(r, c):
        shard, ij = mat.storage[r * Q + c], owned[(r, c)]
        return shard[[ctx.kr(i) for i, _ in ij], [ctx.kc(j) for _, j in ij]]

    got = cc.gather(cc.per_rank(P, Q, mine), 0, 0)
    if got is None:
        return None
    tiles = {ij: t for (r, c), ijs in owned.items() for ij, t in zip(ijs, got[r][c])}
    diag = torch.stack([tiles[(i, i)] for i in range(nt)])
    sub = torch.stack([tiles[(i + 1, i)] for i in range(nt - 1)]) if nt > 1 else diag[:0]
    return diag, torch.cat([sub, torch.zeros_like(diag[:1])])


def extract_band(red: BandReduction) -> np.ndarray:
    """Compact band storage of the reduced matrix, on the host:
    ``band[r, j] = A[j + r, j]`` for ``r = 0 .. band`` (LAPACK's lower 'sb'
    layout, ``(band + 1, n)``, zero past the matrix). Only the band's
    diagonals are read, not the reflectors below it. The gather runs on the
    device over the diagonal and first sub-diagonal tiles only, so the
    full matrix is never joined and only the ``O(n band)`` band crosses to
    the host (reference ``band_to_tridiag/mc.h:91-270``). In the
    multi-process form every process calls it; the band reaches the
    process of rank (0, 0), and the other processes get None."""
    mat = red.matrix
    n, b = mat.size.row, red.band
    if n == 0:
        return np.zeros((b + 1, 0), dtype=np.dtype(str(mat.dtype).removeprefix("torch.")))
    nt, nb = mat.dist.nr_tiles.row, mat.block_size.row
    got = _band_tiles(mat)
    if got is None:
        return None
    diag, sub = got
    dev = diag.device
    rr = torch.arange(b + 1, device=dev)[:, None] + torch.arange(nb, device=dev)[None, :]
    cc_ = torch.arange(nb, device=dev).expand(b + 1, nb)
    in_diag = rr < nb               # else the entry lives in the sub-diagonal tile
    fd = diag[:, torch.where(in_diag, rr, 0), cc_]           # (nt, b+1, nb)
    fs = sub[:, torch.where(in_diag, 0, rr - nb), cc_]
    tiles = torch.where(in_diag[None], fd, fs)
    return tiles.permute(1, 0, 2).reshape(b + 1, nt * nb)[:, :n].cpu().numpy()  # dlaf: disable=lint-host-sync(the band goes to the host chase)
