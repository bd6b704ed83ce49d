"""Back-transformations: eigenvectors of the tridiagonal -> of the band ->
of the original matrix.

Port of ``dlaf_tpu/eigensolver/back_transform.py`` (reference
``eigensolver/bt_band_to_tridiag``, ``bt_reduction_to_band``), local and
distributed, reading the storage the chase and the reduction to band
leave:

* :func:`bt_band_to_tridiag` applies the chase's reflectors in reverse
  sweep order. "blocked" (the default) takes ``G`` consecutive sweeps at
  one chase step level as a ``(b+G-1, G)`` staircase V, a compact-WY
  ``I - V T V^H`` (``larft``) and two products through ``blas.mm``; the T
  factors of a block of sweeps read only the constant reflectors, so they
  are formed batched, ahead of that block's levels. It works in place on
  one buffer of E and ``b + G - 1`` zero rows, and skips the levels that
  start below row n (they act on zeros). ``_bt_b2t_scan``, the
  reference's "sweeps" form (one batched rank-1 segment update a sweep),
  is on no path: the tests hold the blocked form against it. Distributed, the
  reflectors mix rows only, so one ``all_to_all`` along the row axis turns
  the block-cyclic rows into full rows of a slice of columns, the
  reflectors are applied locally, and a second ``all_to_all`` restores
  the layout. Ranks that share a device apply the reflectors once, to
  their columns side by side in that buffer, each rank's own copy released
  before the reflectors are uploaded.
* :func:`bt_reduction_to_band` applies the reduction's reflector blocks in
  reverse order, ``C <- (I - V T V^H) C``: locally two products and one T
  a block; distributed (unrolled, or the scan form over telescoped windows
  under ``dist_step_mode``) the V sub-panel gathered as in the forward
  reduction, ``W2 = V^H C`` by partial products all-reduced along the row
  axis, and ``C -= V T W2`` on each rank. The builders' ``la=True`` forms
  block k+1's T factor (and gathers its panel) before block k's bulk: the
  same operations, bitwise the same result; on one stream it only reorders
  launches, so no path turns it on.

Records (:mod:`..obs`): the ``bt_band_to_tridiag`` and
``bt_reduction_to_band`` entry spans with the reference's flop models and
attrs (``back_transform.py:269, 577``: ``impl`` is "blocked", ``group``
the resolved group, ``bt_lookahead`` 0); on a grid the reflector-block
steps ``bt_r2b.step<p>.panel|bulk`` and the scan form's
``bt_r2b.scanstep``; the program telemetry sites
``bt_reduction_to_band.local`` and ``.dist`` (:mod:`..obs.telemetry`).

Not ported: the reference's ``matrix/memory.py`` placement (the port puts
tensors on an explicit device with ``torch.as_tensor``), and its
``route=`` argument: an eager call reads the active autotune route as it
runs (the eigensolver applies it around this stage, :mod:`..autotune`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config, obs
from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..matrix.matrix import Matrix
from ..matrix.panel import (DistContext, element_valid, gather_sub_panel, gather_sub_panel_dyn,
                            pad_sub_panel_to_tiles, tiles_of_rolled, to_device,
                            uniform_slot_start)
from ..matrix.tiling import _axis_perm_inv, global_to_tiles, storage_tile_grid, tiles_to_global
from ..tile_ops import blas as tb
from ..tile_ops.lapack import larft
from ..types import ceil_div, dtype_name, telescope_windows, total_ops
from .band_to_tridiag import TridiagResult
from .reduction_to_band import BandReduction

# ---------------------------------------------------------------------------
# Chase back-transform (reference back_transform.py:68-317)
# ---------------------------------------------------------------------------


def _bt_b2t_blocked(v_all: torch.Tensor, tau_all: torch.Tensor, e: torch.Tensor, *, b: int,
                    n: int, group: int) -> torch.Tensor:
    """``E <- Q E`` by compact-WY groups of ``group`` sweeps (reference
    ``_bt_b2t_blocked``; :func:`_bt_b2t_blocked_inplace` on a padded copy
    of ``e``); a new tensor."""
    e_pad = e.new_zeros((n + b + group - 1, e.shape[1]))
    e_pad[:n] = e
    _bt_b2t_blocked_inplace(v_all, tau_all, e_pad, b=b, n=n, group=group)
    return e_pad[:n]


def _bt_b2t_blocked_inplace(v_all: torch.Tensor, tau_all: torch.Tensor, e_pad: torch.Tensor, *,
                            b: int, n: int, group: int) -> None:
    """``E <- Q E`` in place on ``e_pad``, E in its first ``n`` rows and
    ``b + group - 1`` zero rows below, by compact-WY groups of ``group``
    (= G <= b+1) sweeps: at one chase step level, G consecutive sweeps'
    reflectors form a ``(b+G-1, G)`` staircase V (column j is sweep s0+j's
    reflector at row offset j, its head 1 on the diagonal). Sweep blocks
    run in descending order, step levels ascending within a block: a
    reflector (s, t) overlaps (s+k, t-1), so a lower level holding higher
    sweeps goes first, and levels two steps apart are disjoint for G <=
    b+1. Each level is ``T = larft(V)`` and two products; a block's T
    factors are formed batched before its levels. A level whose rows all
    lie below row ``n`` acts on zeros and is skipped (the reflectors are
    zero there), so the zero rows below E need only cover the last
    level that starts above it; the last block's missing sweeps are zero
    columns of its staircase."""
    dlaf_assert(group <= b + 1, "bt_b2t blocked: group must be <= band+1")
    n_sweeps, n_steps, _ = v_all.shape
    G = group
    L = b + G - 1
    dlaf_assert(e_pad.shape[0] >= n + L - 1, "bt_b2t blocked: too few padding rows")
    dev = e_pad.device
    # staircase positions: column j takes its reflector at rows j .. j+b-1
    rows = (torch.arange(G, device=dev)[:, None] + torch.arange(b, device=dev)[None, :])
    cols = torch.arange(G, device=dev)[:, None].expand(G, b)
    for blk in range(ceil_div(n_sweeps, G) - 1, -1, -1):
        s0, s1 = blk * G, min((blk + 1) * G, n_sweeps)
        vb = v_all[s0:s1].transpose(0, 1)                           # (n_steps, g, b)
        stair = v_all.new_zeros((n_steps, L, G))
        stair[:, rows[:s1 - s0], cols[:s1 - s0]] = vb
        taus = tau_all.new_zeros((G, n_steps))
        taus[:s1 - s0] = tau_all[s0:s1]
        t_all = larft(stair, taus.T.conj())
        stair_h = stair.mH
        for t in range(n_steps):
            base = s0 + 1 + t * b
            if base >= n:
                break
            seg = e_pad[base:base + L]
            w = t_all[t] @ tb.mm(stair_h[t], seg)
            seg -= tb.mm(stair[t], w)


def _bt_b2t_scan(v_all: torch.Tensor, tau_all: torch.Tensor, e: torch.Tensor, *, b: int,
                 n: int) -> torch.Tensor:
    """``E <- Q E`` one sweep at a time, in reverse sweep order (reference
    ``_bt_b2t_scan``): a sweep's reflectors act on disjoint row segments,
    so a sweep is one batched rank-1 update of its ``(n_steps, b, m)``
    segment."""
    n_sweeps, n_steps, _ = v_all.shape
    m = e.shape[1]
    seg_len = n_steps * b
    e_pad = e.new_zeros((n + seg_len + 1, m))
    e_pad[:n] = e
    for s in range(n_sweeps - 1, -1, -1):
        v_s, tau_s = v_all[s], tau_all[s]
        seg = e_pad[s + 1:s + 1 + seg_len].view(n_steps, b, m)
        w = torch.einsum("tb,tbm->tm", v_s.conj(), seg)
        seg -= tau_s.conj()[:, None, None] * v_s[..., None] * w[:, None, :]
    return e_pad[:n]


def _effective_group(b: int, n_sweeps: int, group: int, device_type: str) -> int:
    """The compact-WY group size: 0 = auto, the band on cuda (wide
    products) and ``min(band, 64)`` on the CPU (the reference's CPU
    choice); clamped to ``[1, min(band+1, n_sweeps)]``, the disjointness
    bound of the blocked reordering."""
    if group <= 0:
        group = b if device_type == "cuda" else min(b, 64)
    return max(1, min(group, b + 1, n_sweeps))


def _chase_buffer(n: int, m: int, b: int, n_sweeps: int, dtype, device) -> torch.Tensor:
    """A zero ``(n + L, m)`` buffer for the ``(n, m)`` E of the blocked
    chase back-transform: ``L = b + G - 1`` rows below E for the automatic
    group G on ``device``."""
    g = _effective_group(b, n_sweeps, 0, torch.device(device).type)
    return torch.zeros((n + b + g - 1, m), dtype=dtype, device=device)


def _apply_chase_reflectors(v_all, tau_all, e_pad, *, b: int, n: int) -> None:
    """The chase's reflectors applied in place to E in ``e_pad``'s first
    ``n`` rows (:func:`_chase_buffer`)."""
    g = _effective_group(b, int(v_all.shape[0]), 0, e_pad.device.type)
    _bt_b2t_blocked_inplace(v_all, tau_all, e_pad, b=b, n=n, group=g)


def _to(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: to a CUDA device through pinned memory,
    asynchronously (a pageable copy would make the host wait)."""
    t = torch.as_tensor(x)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _reflectors(tri: TridiagResult, device):
    """The chase's reflectors and taus as tensors on ``device``, and its
    phases there for a complex chase (None for a real one: they are all
    1)."""
    v = _to(tri.v, device)
    phase = _to(tri.phase, device) if v.is_complex() else None
    return v, _to(tri.tau, device), phase


def _bt_b2t_local(tri: TridiagResult, e: torch.Tensor) -> torch.Tensor:
    """``E <- Q E`` on one device: the phases (complex), then the
    reflectors; a new tensor."""
    n = tri.d.shape[0]
    v, tau, phase = _reflectors(tri, e.device)
    buf = _chase_buffer(n, e.shape[1], tri.band, int(v.shape[0]), v.dtype, e.device)
    buf[:n] = e
    if v.is_complex():
        buf[:n] *= phase[:, None]
    _apply_chase_reflectors(v, tau, buf, b=tri.band, n=n)
    return buf[:n]


def _dist_bt_b2t(tri: TridiagResult, mat: Matrix) -> list:
    """The distributed chase back-transform (reference
    ``_build_dist_bt_b2t``) of ``mat``'s shards; returns the new shards.
    Ranks that share a device apply the reflectors once, to the columns
    they received side by side; in the multi-process form each process
    applies them to its rank's. The two give the same bits on the CPU and
    on the card (the multi-process tests and ``chip_smoke.py``): each
    column's products sum in one order whatever the width."""
    dist = mat.dist
    n = dist.size.row
    nb = dist.block_size.row
    P, Q = dist.grid_size.row, dist.grid_size.col
    Sr, _, ltr, ltc = storage_tile_grid(dist)
    ntr = dist.nr_tiles.row
    chunk = ceil_div(ltc, P) if ltc else 0
    ltc_pad = chunk * P
    # static permutations: a2a slot (p*ltr + l) <-> global row tile g
    row_order = [0] * Sr
    slots = _axis_perm_inv(ntr, P, dist.source_rank.row, ltr)
    for g, slot in enumerate(slots):
        row_order[g] = slot
    used = set(slots)
    for i, s in enumerate(s for s in range(Sr) if s not in used):
        row_order[ntr + i] = s
    inv_order = [0] * Sr
    for pos, slot in enumerate(row_order):
        inv_order[slot] = pos
    cplx = np.issubdtype(tri.v.dtype, np.complexfloating)
    dtype = torch.complex128 if cplx else torch.float64
    lts = cc.per_rank(P, Q, lambda r, c: mat.storage[r * Q + c])
    x = cc.per_rank(P, Q, lambda r, c: torch.nn.functional.pad(
        lts[r][c].to(dtype), (0, 0, 0, 0, 0, ltc_pad - ltc)))
    # block-cyclic rows -> full rows x 1/P of my column group's columns
    x = cc.all_to_all(x, ROW_AXIS, split_axis=1, concat_axis=0)
    es = cc.per_rank(P, Q, lambda r, c: x[r][c].index_select(
        0, to_device(row_order, x[r][c].device)).permute(0, 2, 1, 3)
        .reshape(Sr * nb, chunk * nb)[:n])
    del x
    by_dev: dict = {}
    for r, c in cc.local_ranks(P, Q):
        by_dev.setdefault(es[r][c].device, []).append((r, c))
    for dev, ranks in by_dev.items():
        # the ranks' columns side by side, straight into the padded buffer
        # the reflectors act on; each rank's own copy goes at once, before
        # the reflectors come up
        parts = [es[r][c] for r, c in ranks]
        e = _chase_buffer(n, sum(p.shape[1] for p in parts), tri.band, int(tri.v.shape[0]),
                          dtype, dev)
        torch.cat(parts, dim=1, out=e[:n])
        del parts
        for r, c in ranks:
            es[r][c] = None
        v, tau, phase = _reflectors(tri, dev)
        if cplx:
            e[:n] *= phase[:, None]
        _apply_chase_reflectors(v, tau, e, b=tri.band, n=n)
        del v, tau, phase
        split = e[:n].split(chunk * nb, dim=1)
        for i, (r, c) in enumerate(ranks):
            es[r][c] = split[i]
        # the ranks' views are the buffer's last holders
        del e, split
    y = cc.per_rank(P, Q, lambda r, c: torch.nn.functional.pad(es[r][c], (0, 0, 0, Sr * nb - n))
                    .reshape(Sr, nb, chunk, nb).permute(0, 2, 1, 3)
                    .index_select(0, to_device(inv_order, es[r][c].device)))
    del es
    y = cc.all_to_all(y, ROW_AXIS, split_axis=0, concat_axis=1)
    return [None if y[r][c] is None else y[r][c][:, :ltc].contiguous()
            for r in range(P) for c in range(Q)]


def bt_band_to_tridiag(tri: TridiagResult, evecs):
    """Eigenvectors of the BAND matrix from those of the tridiagonal: the
    complex phases, then the chase's reflectors in reverse sweep order, by
    compact-WY groups of the automatic size (:func:`_effective_group`).

    ``evecs`` a tensor (returns a new tensor on its device) or a
    :class:`~..matrix.matrix.Matrix`, on one rank or a grid (returns a new
    Matrix in its layout; reference ``bt_band_to_tridiag/api.h:21-22``)."""
    with _bt_b2t_entry_span(tri, evecs):
        return _bt_band_to_tridiag(tri, evecs)


def _bt_b2t_entry_span(tri: TridiagResult, evecs):
    """The reference's entry span: the chase back-transform's flop model,
    ``n^2 m`` multiplications and additions (one rank-1 segment update
    per reflector)."""
    def attrs():
        n = tri.d.shape[0]
        if isinstance(evecs, Matrix):
            m, dev = evecs.size.col, evecs.device.type
            grid = f"{evecs.dist.grid_size.row}x{evecs.dist.grid_size.col}"
        else:
            e = torch.as_tensor(evecs)
            m, dev, grid = (e.shape[1] if e.ndim > 1 else 1), e.device.type, "1x1"
        group = _effective_group(tri.band, int(tri.v.shape[0]), 0, dev)
        return dict(flops=total_ops(tri.v.dtype, n ** 2 * m, n ** 2 * m), n=n, m=m,
                    band=tri.band, dtype=dtype_name(tri.v.dtype), impl="blocked", group=group,
                    grid=grid)

    return obs.entry_span("bt_band_to_tridiag", attrs)


def _bt_band_to_tridiag(tri: TridiagResult, evecs):
    if not isinstance(evecs, Matrix):
        return _bt_b2t_local(tri, torch.as_tensor(evecs))
    if not evecs.distributed:
        out = _bt_b2t_local(tri, tiles_to_global(evecs.storage, evecs.dist))
        return Matrix(evecs.dist, global_to_tiles(out, evecs.dist), evecs.grid)
    dlaf_assert(evecs.size.row == tri.d.shape[0], "bt_band_to_tridiag: eigenvector rows != n")
    dlaf_assert(evecs.block_size.row == evecs.block_size.col,
                "bt_band_to_tridiag: square blocks only (distributed)")
    return Matrix(evecs.dist, _dist_bt_b2t(tri, evecs), evecs.grid)


# ---------------------------------------------------------------------------
# Reflector-block back-transform (reference back_transform.py:320-645)
# ---------------------------------------------------------------------------

def _bt_r2b_local(a_v: torch.Tensor, taus: torch.Tensor, e: torch.Tensor, *, nb: int,
                  la: bool = False) -> torch.Tensor:
    """``C <- (I - V T V^H) C`` per reflector block of width ``nb`` (the
    band), in reverse order, IN PLACE on ``e``. With ``la`` block k+1's
    T factor is formed before block k's products: bitwise the same."""
    n = a_v.shape[0]
    nt = ceil_div(n, nb) if n else 0
    ks = [k for k in range(nt - 2, -1, -1) if n - (k + 1) * nb > 0]

    def chain(k):
        k1 = (k + 1) * nb
        m_p = n - k1
        vf = a_v[k1:, k * nb: k * nb + nb]
        v = torch.tril(vf, -1) + torch.eye(m_p, nb, dtype=a_v.dtype, device=a_v.device)
        return k1, v, larft(v, taus[k])

    def bulk(k1, v, t):
        w = t @ tb.mm(v.mH, e[k1:])
        e[k1:] -= tb.mm(v, w)

    if la:
        pend = chain(ks[0]) if ks else None
        for i in range(len(ks)):
            cur = pend
            pend = chain(ks[i + 1]) if i + 1 < len(ks) else None
            bulk(*cur)
        return e
    for k in ks:
        bulk(*chain(k))
    return e


def _c_rows(ctx_c: DistContext, v_tiles, lu: int, nrows: int, first: int, bdy: int, n: int,
            lts_c):
    """Per rank, V's tiles at the rank's C row slots ``lu .. lu+nrows-1``
    (tile ``g`` of C from tile ``g - first`` of ``v_tiles[r][c]``, rows
    outside ``[bdy, n)`` zero): formed once per grid row and device."""
    nt, nb = ctx_c.nt.row, ctx_c.mb

    def one(r, c):
        g = ctx_c.g_rows(r, lu, nrows)
        dev = lts_c[r][c].device
        mask = to_device(element_valid(g, nb, bdy, n), dev, torch.bool)
        sel = to_device(np.clip(g - first, 0, nt - first - 1), dev)
        return torch.where(mask[:, :, None], v_tiles[r][c].index_select(0, sel), 0.0)

    P, Q = cc.grid_shape(lts_c)
    return cc.per_rank_once(P, Q, lambda r, c: (r, lts_c[r][c].device), one)


def _r2b_update(v_my, t, lts_c, lu: int) -> None:
    """A panel's bulk on every rank: ``W2 = V^H C`` (partial products
    all-reduced along the row axis), ``W2 <- T W2``, ``C -= V W2``."""
    P, Q = cc.grid_shape(lts_c)
    part = cc.per_rank(P, Q, lambda r, c: tb.contract("rab,rcad->cbd", v_my[r][c].conj(),
                                                      lts_c[r][c][lu:]))
    w2 = cc.all_reduce(part, ROW_AXIS, shared=True)
    del part
    w2 = cc.per_rank_once(P, Q, lambda r, c: (c, lts_c[r][c].device),
                          lambda r, c: tb.contract("xb,cbd->cxd", t[r][c], w2[r][c]))
    for r, c in cc.local_ranks(P, Q):
        lts_c[r][c][lu:] -= tb.contract("rab,cbd->rcad", v_my[r][c], w2[r][c])


def _taus_on(taus: torch.Tensor, lts):
    """The taus on every rank's device (once per device)."""
    P, Q = cc.grid_shape(lts)
    return cc.per_rank_once(P, Q, lambda r, c: lts[r][c].device,
                            lambda r, c: taus.to(lts[r][c].device))


def _dist_bt_r2b(lts_a: cc.Shards, taus: torch.Tensor, lts_c: cc.Shards, dist_a, dist_c,
                 band: int, la: bool = False) -> None:
    """The distributed reflector-block back-transform (reference
    ``_build_dist_bt_r2b``), IN PLACE on ``lts_c``: panel p (element
    columns ``[p b, (p+1) b)`` of V) acts on C's rows from ``(p+1) b``, in
    reverse order. Per panel: the V sub-panel gathered (once per device),
    ``T = larft(V)``, V at each grid row's C slots, then the bulk
    (:func:`_r2b_update`). With ``la`` panel p-1's gather and T run before
    panel p's bulk."""
    ctx_a, ctx_c = DistContext(dist_a), DistContext(dist_c)
    nt, nb, n = dist_a.nr_tiles.row, dist_a.block_size.row, dist_a.size.row
    b = band
    npan = ceil_div(n, b) - 1 if n else 0
    P, Q = cc.grid_shape(lts_a)
    tau_d = _taus_on(taus, lts_a)

    def chain(p):
        """Panel p's prefix (constant storage only), or None when no rank
        has a row below its boundary."""
        bdy = (p + 1) * b
        got = gather_sub_panel(ctx_a, lts_a, pb=p * b, b=b, n=n)
        if got is None:
            return None
        pan, _, tr0, ro, _, _ = got
        m_p = (nt - tr0) * nb - ro
        luc = ctx_c.row_start(tr0)
        nrows_c = ctx_c.ltr - luc
        if nrows_c <= 0:
            return None

        def factor(r, c):
            x = pan[r][c]
            v = torch.tril(x, -1) + torch.eye(m_p, b, dtype=x.dtype, device=x.device)
            return larft(v, tau_d[r][c][p]), pad_sub_panel_to_tiles(ctx_a, v, tr0=tr0, ro=ro)

        fac = cc.per_rank_once(P, Q, lambda r, c: pan[r][c].device, factor)
        v_my = _c_rows(ctx_c, cc.per_rank(P, Q, lambda r, c: fac[r][c][1]), luc, nrows_c, tr0,
                       bdy, n, lts_c)
        return luc, cc.per_rank(P, Q, lambda r, c: fac[r][c][0]), v_my

    pend = pend_p = None
    for p in range(npan - 1, -1, -1):
        with obs.named_span("bt_r2b.step%03d.panel", p):
            ch = chain(p)
        if ch is None:
            continue
        if not la:
            luc, t, v_my = ch
            with obs.named_span("bt_r2b.step%03d.bulk", p):
                _r2b_update(v_my, t, lts_c, luc)
            continue
        if pend is not None:
            # this chain's collectives ran ahead of the pending bulk
            cc.record_overlapped("bt_r2b_dist", ROW_AXIS, 1)
            cc.record_overlapped("bt_r2b_dist", COL_AXIS, 1)
            luc, t, v_my = pend
            with obs.named_span("bt_r2b.step%03d.bulk", pend_p):
                _r2b_update(v_my, t, lts_c, luc)
        pend, pend_p = ch, p
    if pend is not None:
        luc, t, v_my = pend
        with obs.named_span("bt_r2b.step%03d.bulk", pend_p):
            _r2b_update(v_my, t, lts_c, luc)


def _dist_bt_r2b_scan(lts_a: cc.Shards, taus: torch.Tensor, lts_c: cc.Shards, dist_a,
                      dist_c, band: int) -> None:
    """The scan form (reference ``_build_dist_bt_r2b_scan``), IN PLACE on
    ``lts_c``: uniform steps over telescoped windows, mirrored for the
    reverse sweep (panel p touches C rows from (p+1) b, so the late panels
    run on a small bottom window that grows as p falls). Every step
    gathers the window-height masked panel column, top-aligned by a roll,
    and updates all the window's row slots under element masks. The
    gather and T read only constant storage and already run before the
    bulk."""
    ctx_a, ctx_c = DistContext(dist_a), DistContext(dist_c)
    nt, nb, n = dist_a.nr_tiles.row, dist_a.block_size.row, dist_a.size.row
    P, Q = dist_a.grid_size.row, dist_a.grid_size.col
    b = band
    npan = ceil_div(n, b) - 1 if n else 0
    if npan <= 0:
        return
    tau_d = _taus_on(taus, lts_a)

    def step(subs_a, subs_c, p, lu_off, lc_off):
        base = lu_off * P
        pan, bdy, _, _, _, _, _ = gather_sub_panel_dyn(ctx_a, subs_a, p=p, b=b, n=n,
                                                       row_off=lu_off, col_off=lc_off)
        m_w = (nt - base) * nb

        def factor(r, c):
            x = pan[r][c]
            v = torch.tril(x, -1) + torch.eye(m_w, b, dtype=x.dtype, device=x.device)
            return larft(v, tau_d[r][c][p]), tiles_of_rolled(ctx_a, v, bdy, base * nb)

        fac = cc.per_rank_once(P, Q, lambda r, c: pan[r][c].device, factor)
        v_my = _c_rows(ctx_c, cc.per_rank(P, Q, lambda r, c: fac[r][c][1]), lu_off,
                       ctx_c.ltr - lu_off, base, bdy, n, subs_c)
        _r2b_update(v_my, cc.per_rank(P, Q, lambda r, c: fac[r][c][0]), subs_c, 0)

    def window(pos, seg_len):
        p_lo = npan - pos - seg_len
        t_min = (p_lo * b) // nb
        return uniform_slot_start(t_min, P), uniform_slot_start(t_min, Q)

    for (lu_off, lc_off), i0, seg_len in telescope_windows(npan, window):
        subs_a = cc.per_rank(P, Q, lambda r, c: lts_a[r][c][lu_off:, lc_off:])
        subs_c = cc.per_rank(P, Q, lambda r, c: lts_c[r][c][lu_off:])
        for i in range(i0, i0 + seg_len):
            with obs.named_span("bt_r2b.scanstep"):
                step(subs_a, subs_c, npan - 1 - i, lu_off, lc_off)


def _bt_r2b_program(lts_a, taus, lts_c, dist_a, dist_c, band, *, scan):
    """The distributed reflector blocks in place on ``lts_c``, returned."""
    (_dist_bt_r2b_scan if scan else _dist_bt_r2b)(lts_a, taus, lts_c, dist_a, dist_c, band)
    return lts_c


def bt_reduction_to_band(red: BandReduction, evecs):
    """Eigenvectors of the ORIGINAL matrix from those of the band matrix:
    the reduction's reflector blocks in reverse order.

    Local when ``red.matrix`` is on one rank (``evecs`` a tensor returns a
    tensor, a Matrix a Matrix); distributed when both live on a grid
    (Matrix -> Matrix; reference ``bt_reduction_to_band/api.h:18-23``), by
    the step form ``dist_step_mode`` picks for ``ceil(n/band) - 1``
    panels. ``evecs`` is not modified."""
    a = red.matrix

    def attrs():
        # the reference's flop model: n^2 m multiplications and additions
        n = a.size.row
        if isinstance(evecs, Matrix):
            m = evecs.size.col
        else:
            e = torch.as_tensor(evecs)
            m = e.shape[1] if e.ndim > 1 else 1
        grid = (f"{a.dist.grid_size.row}x{a.dist.grid_size.col}"
                if isinstance(evecs, Matrix) and a.distributed else "1x1")
        return dict(flops=total_ops(a.dtype, n ** 2 * m, n ** 2 * m), n=n, m=m, band=red.band,
                    dtype=dtype_name(a.dtype), bt_lookahead=0, grid=grid)

    with obs.entry_span("bt_reduction_to_band", attrs):
        return _bt_reduction_to_band(red, evecs)


def _bt_reduction_to_band(red: BandReduction, evecs):
    a = red.matrix
    dev = a.device.type
    if isinstance(evecs, Matrix) and a.distributed:
        dlaf_assert(evecs.grid is not None and evecs.grid.size == a.grid.size,
                    "bt_reduction_to_band: V and C must share the grid")
        dlaf_assert(evecs.block_size.row == a.block_size.row,
                    "bt_reduction_to_band: C row block != V block")
        dlaf_assert(evecs.size.row == a.size.row, "bt_reduction_to_band: C rows != n")
        dlaf_assert(a.block_size.row % red.band == 0,
                    "bt_reduction_to_band: band must divide the block size")
        P, Q = a.dist.grid_size.row, a.dist.grid_size.col
        shards = [s if s is None else s.to(a.dtype, copy=True) for s in evecs.storage]
        lts_a = cc.per_rank(P, Q, lambda r, c: a.storage[r * Q + c])
        lts_c = cc.per_rank(P, Q, lambda r, c: shards[r * Q + c])
        scan = config.resolve_step_mode(max(ceil_div(a.size.row, red.band) - 1, 1),
                                        dev) == "scan"
        obs.telemetry.call("bt_reduction_to_band.dist", _bt_r2b_program, lts_a, red.taus,
                           lts_c, a.dist, evecs.dist, red.band, scan=scan)
        return Matrix(evecs.dist, shards, evecs.grid)
    a_v = tiles_to_global(a.storage, a.dist)
    if isinstance(evecs, Matrix):
        e = tiles_to_global(evecs.storage, evecs.dist).to(a_v.dtype)
    else:
        e = torch.as_tensor(evecs).to(a_v.device, a_v.dtype, copy=True)
    out = obs.telemetry.call("bt_reduction_to_band.local", _bt_r2b_local, a_v,
                             red.taus.to(a_v.device), e, nb=red.band)
    if isinstance(evecs, Matrix):
        return Matrix(evecs.dist, global_to_tiles(out, evecs.dist), evecs.grid)
    return out
