"""Numerical-quality probes (the ``DLAF_ACCURACY`` knob).

Port of ``dlaf_tpu/obs/accuracy.py``: estimators of the backward-error
quantities the miniapps' ``--check-result`` reports, computed on the
device from the algorithm's outputs, with no gather of a whole matrix:

* the Cholesky residual ``|A - L L^H|_F / |A|_F`` (and the ``U^H U`` form);
* the triangular-solve residual ``|op(T) X - alpha B|_F / |B|_F``;
* the HEGST (gen_to_std) residual ``|L C L^H - A|_F / |A|_F``;
* the eigensolver's Frobenius eigenpair residual ``|A Z - [B] Z
  diag(lam)|_F / |A|_F``, the sampled per-pair maximum ``max_i |A z_i -
  lam_i [B] z_i|_2 / |A|_F`` and the orthogonality ``|Z^H Z - I|_F``;
* the D&C's per-level deflation fraction (emitted by
  :mod:`..eigensolver.tridiag_solver`) and the serve queue's per-request
  residuals (:mod:`..serve.queue`).

Modes (``Configuration.accuracy``): ``"1"``, the Hutchinson probe: for a
residual matrix ``R``, ``|R Omega|_F / sqrt(k)`` with ``k`` seeded
Rademacher columns is an unbiased estimate of ``|R|_F``, O(n^2 k) device
work; ``"full"``, the exact residual, the same computation with ``Omega =
I``; ``"0"``, no records in timed runs, and an explicit check uses the
``"1"`` probe. The probe columns come from numpy's ``default_rng`` with
the reference's seed, so they are bitwise the reference's.

A matrix on a grid is probed where it lies: each rank contracts its own
block-cyclic tiles against the probe block (replicated), and the partial
products meet in ``comm.collectives.all_reduce`` over both grid axes, on
the single controller and in the multi-process form alike (O(n k) per
rank, counted like any collective). The products are plain
``torch.matmul`` in the matrix's dtype, outside any kernel, as the
reference computes them outside its Pallas kernels. The cross-rank sums
reassociate, so a distributed estimate matches the one-rank value to
rounding, not bitwise.

:func:`emit` is the one record shape: an ``accuracy`` record (site,
metric, value, ``bound_ratio = value / (c n eps)``, n, nb, dtype,
platform, the mode in attrs), the ``dlaf_accuracy_ratio{site,metric}``
gauge, ``dlaf_accuracy_nonfinite_total`` for a non-finite value and the
flight recorder's ``accuracy_breach`` trigger when a budget is blown.
``platform`` is the device type of the checked result (``cuda``,
``cpu``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..types import dtype_name

#: Probe columns of the ``"1"`` mode (the reference's; the relative std
#: of the squared estimate is at most sqrt(2/8)).
DEFAULT_PROBES = 8
#: Seed of the probe columns and of the eigenpair column sample (the
#: reference's).
PROBE_SEED = 20260804


def resolved_mode(mode: Optional[str] = None) -> str:
    """The estimator mode: ``mode`` if given, else the knob, with ``"0"``
    resolving to the ``"1"`` probe for an explicit check."""
    if mode is None:
        from ..config import get_configuration

        mode = get_configuration().accuracy
    return "1" if mode == "0" else mode


def enabled() -> bool:
    """Do timed runs compute and emit accuracy records (knob not
    ``"0"``)?"""
    from ..config import get_configuration

    return get_configuration().accuracy != "0"


def _probe_columns(n: int, mode: str, k: int, seed: int):
    """``(omega, scale)``: the ``(n, k)`` float64 Rademacher probe block
    and the ``1/sqrt(k)`` normalization, or ``(None, 1.0)`` for the exact
    identity probe (mode ``"full"``)."""
    if mode == "full":
        return None, 1.0
    k = max(1, min(k, max(n, 1)))
    rng = np.random.default_rng(seed)
    om = (rng.integers(0, 2, size=(n, k)) * 2 - 1).astype(np.float64)
    return om, 1.0 / math.sqrt(k)


def _sample_columns(n: int, mode: str, k: int, seed: int) -> np.ndarray:
    """The seeded eigenpair column sample (mode ``"1"``) or every column
    (mode ``"full"``)."""
    if mode == "full" or k >= n:
        return np.arange(n)
    return np.sort(np.random.default_rng(seed + 1).choice(n, size=k, replace=False))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _sq(x: torch.Tensor) -> torch.Tensor:
    """Squared Frobenius norm (real, for complex ``x`` too)."""
    return torch.sum(torch.real(x * torch.conj(x)))


def _rel(num2, den2, scale: float) -> torch.Tensor:
    """``sqrt(num2) * scale / sqrt(den2)``, the denominator kept at least
    the dtype's smallest normal."""
    den = torch.sqrt(den2)
    return torch.sqrt(num2) * scale / torch.clamp(den, min=torch.finfo(den.dtype).tiny)


def _tri(x: torch.Tensor, mask: str) -> torch.Tensor:
    """``x`` with everything outside ``mask`` zeroed: ``"G"`` all,
    ``"L"``/``"U"`` a triangle with its diagonal, ``"SL"``/``"SU"`` the
    strict triangles."""
    if mask == "G":
        return x
    k = {"L": 0, "SL": -1, "U": 0, "SU": 1}[mask]
    return torch.tril(x, k) if mask in ("L", "SL") else torch.triu(x, k)


def _herm(x: torch.Tensor, uplo: str) -> torch.Tensor:
    """``tri(x) + stri(x)^H``: the Hermitian matrix of a stored triangle,
    its diagonal as stored (the reference's convention)."""
    return _tri(x, uplo) + _tri(x, "S" + uplo).mH


def _omega(om_np: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(om_np).to(device=like.device, dtype=like.dtype)


def _local(m) -> bool:
    return not m.distributed


class _Ranks:
    """The per-rank view of a distributed matrix: each rank's local tiles
    as one dense block-cyclic matrix, its global tile rows and columns,
    and the verbs that join the ranks' partial products."""

    def __init__(self, mat):
        from ..matrix.tiling import storage_tile_grid

        dist = mat.dist
        self.dist = dist
        self.P, self.Q = dist.grid_size.row, dist.grid_size.col
        _, _, self.ltr, self.ltc = storage_tile_grid(dist)
        self.mb, self.nb = dist.block_size.row, dist.block_size.col
        self.nested = mat.nested()

    def coords(self, r: int, c: int):
        """Global tile rows and columns of rank (r, c)'s local tiles."""
        d = self.dist
        rr = (r - d.source_rank.row) % self.P
        rc = (c - d.source_rank.col) % self.Q
        return (np.arange(self.ltr) * self.P + rr, np.arange(self.ltc) * self.Q + rc)

    def dense(self, r: int, c: int, mask: str) -> torch.Tensor:
        """Rank (r, c)'s local tiles as a ``(ltr*mb, ltc*nb)`` matrix,
        masked to ``mask`` of the global matrix (padding tiles zero)."""
        t = self.nested[r][c]
        gr, gc = self.coords(r, c)
        nt = self.dist.nr_tiles
        dev = t.device
        valid = torch.as_tensor((gr[:, None] < nt.row) & (gc[None, :] < nt.col), device=dev)
        if mask == "G":
            m = valid[:, :, None, None]
        else:
            lower = mask in ("L", "SL")
            strict = mask in ("SL", "SU")
            g_r = torch.as_tensor(gr, device=dev)[:, None]
            g_c = torch.as_tensor(gc, device=dev)[None, :]
            full = valid & ((g_r > g_c) if lower else (g_r < g_c))
            one = torch.ones((self.mb, self.nb), dtype=torch.bool, device=dev)
            tri = (torch.tril(one, -1 if strict else 0) if lower
                   else torch.triu(one, 1 if strict else 0))
            m = full[:, :, None, None] | ((valid & (g_r == g_c))[:, :, None, None] & tri)
        t = torch.where(m, t, torch.zeros((), dtype=t.dtype, device=dev))
        return t.permute(0, 2, 1, 3).reshape(self.ltr * self.mb, self.ltc * self.nb)

    def rows_of(self, x: torch.Tensor, idx: np.ndarray, b: int) -> torch.Tensor:
        """The rows of the tiles ``idx`` (of ``b`` rows each) of a
        replicated ``(rows, k)`` value, padded with zero rows past its
        end."""
        need = (int(idx.max()) + 1) * b if idx.shape[0] else 0
        if x.shape[0] < need:
            x = torch.nn.functional.pad(x, (0, 0, 0, need - x.shape[0]))
        sel = torch.as_tensor((idx[:, None] * b + np.arange(b)[None, :]).reshape(-1),
                              device=x.device)
        return x.index_select(0, sel)

    def psum(self, xs):
        """The per-rank values summed over both grid axes (replicated)."""
        from ..comm import collectives as cc
        from ..comm.grid import COL_AXIS, ROW_AXIS

        return cc.all_reduce(cc.all_reduce(xs, ROW_AXIS, "sum"), COL_AXIS, "sum")

    def mv(self, tiles, om, op: str = "N"):
        """The replicated ``op(T) @ om`` of per-rank masked dense tiles
        ``tiles`` (nested) and a replicated ``om`` (nested, ``(rows, k)``):
        each rank's partial product placed at its global rows (columns
        for ``op`` "T"/"C"), then summed over the grid, cut to the
        matrix's extent."""
        from ..comm import collectives as cc

        d = self.dist
        Gr, Gc = self.P * self.ltr, self.Q * self.ltc

        def part(r, c):
            gr, gc = self.coords(r, c)
            t = tiles[r][c]
            o = om[r][c].to(t.dtype)
            if op == "N":
                y = t @ self.rows_of(o, gc, self.nb)
                out = torch.zeros((Gr * self.mb, y.shape[-1]), dtype=y.dtype, device=y.device)
                sel = (gr[:, None] * self.mb + np.arange(self.mb)[None, :]).reshape(-1)
            else:
                tt = t.mH if op == "C" else t.T
                y = tt @ self.rows_of(o, gr, self.mb)
                out = torch.zeros((Gc * self.nb, y.shape[-1]), dtype=y.dtype, device=y.device)
                sel = (gc[:, None] * self.nb + np.arange(self.nb)[None, :]).reshape(-1)
            out[torch.as_tensor(sel, device=y.device)] = y
            return out

        full = self.psum(cc.per_rank(self.P, self.Q, part))
        ext = d.size.row if op == "N" else d.size.col
        return cc.per_rank(self.P, self.Q, lambda r, c: full[r][c][:ext])

    def masked(self, mask: str):
        from ..comm import collectives as cc

        return cc.per_rank(self.P, self.Q, lambda r, c: self.dense(r, c, mask))

    def sq(self, tiles):
        """``_sq`` of the per-rank (local) values summed over the grid;
        a replicated value's ``_sq`` is taken on each rank alone."""
        from ..comm import collectives as cc

        return self.psum(cc.per_rank(self.P, self.Q, lambda r, c: _sq(tiles[r][c])))

    def mv_herm(self, om, uplo: str):
        """``A_h @ om`` with ``A_h = tri(A) + stri(A)^H`` of this matrix."""
        from ..comm import collectives as cc

        a = self.mv(self.masked(uplo), om, "N")
        b = self.mv(self.masked("S" + uplo), om, "C")
        return cc.per_rank(self.P, self.Q, lambda r, c: a[r][c] + b[r][c])

    def herm_sq(self, uplo: str):
        from ..comm import collectives as cc

        a, b = self.sq(self.masked(uplo)), self.sq(self.masked("S" + uplo))
        return cc.per_rank(self.P, self.Q, lambda r, c: a[r][c] + b[r][c])

    def device(self, r: int, c: int):
        return self.nested[r][c].device

    def add(self, acc, xs):
        """``acc + xs`` per rank (``xs`` where ``acc`` is None)."""
        return xs if acc is None else self.each(lambda r, c: acc[r][c] + xs[r][c])

    def each(self, fn):
        from ..comm import collectives as cc

        return cc.per_rank(self.P, self.Q, fn)

    def scalar(self, xs) -> float:
        from ..comm import collectives as cc

        return float(cc.local_value(xs))


#: Columns of the identity one pass of a distributed ``"full"`` estimate
#: takes: the exact residual is the probe's sum over column blocks of the
#: identity, so no rank holds an ``n x n`` probe or partial product.
FULL_CHUNK = 2048


def _blocks(n: int, om_np: Optional[np.ndarray]) -> list:
    """The probe as column blocks ``(j0, j1, make(device, dtype))``: the
    probe block itself, or (``om_np`` None, mode ``"full"``) blocks of the
    identity's columns, formed on the device."""
    if om_np is not None:
        return [(0, om_np.shape[1], lambda dev, dt: torch.as_tensor(om_np).to(dev, dt))]

    def eye(j0, j1):
        def make(dev, dt):
            x = torch.zeros((n, j1 - j0), dtype=dt, device=dev)
            x[torch.arange(j0, j1, device=dev), torch.arange(j1 - j0, device=dev)] = 1
            return x
        return make

    return [(j0, min(j0 + FULL_CHUNK, n), eye(j0, min(j0 + FULL_CHUNK, n)))
            for j0 in range(0, n, FULL_CHUNK)]


def _global(m) -> torch.Tensor:
    from ..matrix.tiling import tiles_to_global

    return tiles_to_global(m.storage, m.dist)


# ---------------------------------------------------------------------------
# Cholesky: |A - L L^H|_F / |A|_F  (uplo U: |A - U^H U|_F / |A|_F)
# ---------------------------------------------------------------------------

def cholesky_residual(uplo: str, a, factor, mode: Optional[str] = None) -> float:
    """Relative Cholesky residual of ``factor`` against the original ``a``
    (both :class:`~..matrix.matrix.Matrix`, local or on a grid):
    ``|A - L L^H|_F / |A|_F`` (or the ``U^H U`` form), estimated per the
    mode (module docstring)."""
    mode = resolved_mode(mode)
    n = a.size.row
    if n == 0 or a.size.col == 0:
        return 0.0
    om_np, scale = _probe_columns(n, mode, DEFAULT_PROBES, PROBE_SEED)
    if _local(a):
        ag, t = _global(a), _tri(_global(factor), uplo)
        if om_np is None:
            r = ag - (t @ t.mH if uplo == "L" else t.mH @ t)
        else:
            om = _omega(om_np, ag)
            r = ag @ om - (t @ (t.mH @ om) if uplo == "L" else t.mH @ (t @ om))
        return float(_rel(_sq(r), _sq(ag), scale))
    ra, rf = _Ranks(a), _Ranks(factor)
    a_t, f_t = ra.masked("G"), rf.masked(uplo)
    first, second = ("C", "N") if uplo == "L" else ("N", "C")
    num = None
    for _, _, make in _blocks(n, om_np):
        om = ra.each(lambda r, c: make(ra.device(r, c), a.dtype))
        ya = ra.mv(a_t, om, "N")
        z = rf.mv(f_t, rf.mv(f_t, om, first), second)
        num = ra.add(num, ra.each(lambda r, c: _sq(ya[r][c] - z[r][c])))
    den = ra.sq(a_t)
    return ra.scalar(ra.each(lambda r, c: _rel(num[r][c], den[r][c], scale)))


# ---------------------------------------------------------------------------
# Triangular solve: |op(T) X - alpha B|_F / |B|_F
# ---------------------------------------------------------------------------

def trsm_residual(side, uplo, op, diag, alpha, a, b, x, mode: Optional[str] = None) -> float:
    """Relative triangular-solve residual ``|op(T) X - alpha B|_F /
    |B|_F`` (side "R": ``|X op(T) - alpha B|_F``), estimated per mode."""
    mode = resolved_mode(mode)
    ncols = b.size.col
    if b.size.row == 0 or ncols == 0:
        return 0.0
    om_np, scale = _probe_columns(ncols, mode, DEFAULT_PROBES, PROBE_SEED)
    if _local(b):
        t = _tri(_global(a), uplo)
        if diag == "U":
            t = t - torch.diag_embed(torch.diagonal(t)) + torch.eye(t.shape[0], dtype=t.dtype,
                                                                   device=t.device)
        t = {"N": t, "T": t.T, "C": t.mH}[op]
        bg, xg = _global(b), _global(x)
        if om_np is None:
            r = (t @ xg if side == "L" else xg @ t) - alpha * bg
        else:
            om = _omega(om_np, bg)
            r = (t @ (xg @ om) if side == "L" else xg @ (t @ om)) - alpha * (bg @ om)
        return float(_rel(_sq(r), _sq(bg), scale))
    mask = uplo if diag == "N" else ("SL" if uplo == "L" else "SU")
    ra, rb = _Ranks(a), _Ranks(b)
    rx = _Ranks(x)
    t_t, b_t, x_t = ra.masked(mask), rb.masked("G"), rx.masked("G")
    num = None
    for _, _, make in _blocks(ncols, om_np):
        om = rb.each(lambda r, c: make(rb.device(r, c), b.dtype))
        bo = rb.mv(b_t, om, "N")
        if side == "L":
            xo = rx.mv(x_t, om, "N")
            tx = ra.mv(t_t, xo, op)
            if diag == "U":
                tx = ra.each(lambda r, c: tx[r][c] + xo[r][c])
        else:
            to = ra.mv(t_t, om, op)
            if diag == "U":
                to = ra.each(lambda r, c: to[r][c] + om[r][c][:a.size.row].to(to[r][c].dtype))
            tx = rx.mv(x_t, to, "N")
        num = rb.add(num, rb.each(lambda r, c: _sq(tx[r][c] - alpha * bo[r][c])))
    den = rb.sq(b_t)
    return rb.scalar(rb.each(lambda r, c: _rel(num[r][c], den[r][c], scale)))


# ---------------------------------------------------------------------------
# HEGST (gen_to_std): |L C L^H - A|_F / |A|_F  (uplo U: |U^H C U - A|_F)
# ---------------------------------------------------------------------------

def hegst_residual(uplo: str, a, factor, out, mode: Optional[str] = None) -> float:
    """Relative HEGST residual ``|L C L^H - A|_F / |A|_F`` (uplo "U":
    ``|U^H C U - A|_F``), ``A`` and ``C`` Hermitian from their stored
    ``uplo`` triangles, estimated per mode."""
    mode = resolved_mode(mode)
    n = a.size.row
    if n == 0:
        return 0.0
    om_np, scale = _probe_columns(n, mode, DEFAULT_PROBES, PROBE_SEED)
    if _local(a):
        ah, t, ch = _herm(_global(a), uplo), _tri(_global(factor), uplo), _herm(_global(out), uplo)
        if om_np is None:
            r = (t @ ch @ t.mH if uplo == "L" else t.mH @ ch @ t) - ah
        else:
            om = _omega(om_np, ah)
            z = t @ (ch @ (t.mH @ om)) if uplo == "L" else t.mH @ (ch @ (t @ om))
            r = z - ah @ om
        return float(_rel(_sq(r), _sq(ah), scale))
    ra, rf, rc_ = _Ranks(a), _Ranks(factor), _Ranks(out)
    f_t = rf.masked(uplo)
    first, second = ("C", "N") if uplo == "L" else ("N", "C")
    num = None
    for _, _, make in _blocks(n, om_np):
        om = ra.each(lambda r, c: make(ra.device(r, c), a.dtype))
        z = rf.mv(f_t, rc_.mv_herm(rf.mv(f_t, om, first), uplo), second)
        ya = ra.mv_herm(om, uplo)
        num = ra.add(num, ra.each(lambda r, c: _sq(z[r][c] - ya[r][c])))
    den = ra.herm_sq(uplo)
    return ra.scalar(ra.each(lambda r, c: _rel(num[r][c], den[r][c], scale)))


# ---------------------------------------------------------------------------
# Eigensolver: eigenpair residual and orthogonality
# ---------------------------------------------------------------------------

def _eigen_probe(n: int, mode: str, k: int, seed: int):
    """The eigensolver's probe block: ``k`` Rademacher columns (the
    Frobenius and orthogonality estimates), then the sampled one-hot
    columns (exact per-pair residual columns); mode ``"full"``: the
    identity serves both. ``(block, k_rand, scale)``."""
    om_np, scale = _probe_columns(n, mode, k, seed)
    if om_np is None:
        return np.eye(n), n, 1.0
    sel = _sample_columns(n, mode, k, seed)
    onehot = np.zeros((n, sel.shape[0]))
    onehot[sel, np.arange(sel.shape[0])] = 1.0
    return np.concatenate([om_np, onehot], axis=1), om_np.shape[1], scale


def _colmax2(res, rand: int, width: int, prev, r: int, c: int) -> torch.Tensor:
    """The largest squared column norm of a block's sampled residual
    columns (all its columns where no one-hot block follows), folded with
    the previous blocks' (``prev``, nested per rank)."""
    sel = res[:, rand:] if width > rand else res
    m = (torch.max(torch.sum(torch.real(sel * torch.conj(sel)), dim=0)) if sel.shape[1]
         else torch.zeros((), dtype=torch.real(res).dtype, device=res.device))
    return m if prev is None else torch.maximum(prev[r][c], m)


def _eigen_metrics(r, g, den2, k_rand: int, width: int, scale: float) -> torch.Tensor:
    den = torch.clamp(torch.sqrt(den2), min=torch.finfo(torch.sqrt(den2).dtype).tiny)
    fro = torch.sqrt(_sq(r[:, :k_rand])) * scale / den
    r_sel = r[:, k_rand:] if width > k_rand else r
    cols = torch.sum(torch.real(r_sel * torch.conj(r_sel)), dim=0)
    colmax = torch.sqrt(torch.clamp(torch.max(cols), min=0.0) if cols.numel()
                        else torch.zeros((), dtype=den.dtype, device=den.device)) / den
    orth = torch.sqrt(_sq(g[:, :k_rand])) * scale
    return torch.stack([fro, colmax, orth])


def eigen_residuals(uplo: str, a, lam, z, b=None, mode: Optional[str] = None) -> dict:
    """Eigensolver quality estimates for the eigenpairs ``(lam, Z)`` of the
    Hermitian ``a`` (generalized with ``b``): ``{"eigen_residual": |A Z -
    [B] Z diag(lam)|_F / |A|_F, "eigenpair_max": the largest |A z_i -
    lam_i [B] z_i|_2 / |A|_F over the sampled pairs, "orthogonality":
    |Z^H Z - I|_F}``, estimated per mode."""
    mode = resolved_mode(mode)
    n = a.size.row
    if n == 0:
        return {"eigen_residual": 0.0, "eigenpair_max": 0.0, "orthogonality": 0.0}
    lam_np = np.asarray(lam, dtype=np.float64)
    om_np, k_rand, scale = _eigen_probe(n, mode, DEFAULT_PROBES, PROBE_SEED)
    width = om_np.shape[1]
    if _local(a):
        ah, zg = _herm(_global(a), uplo), _global(z)
        om = _omega(om_np, zg)
        lam_om = torch.as_tensor(lam_np).to(device=zg.device, dtype=zg.dtype)[:, None] * om
        zo, zl = zg @ om, zg @ lam_om
        r = ah @ zo - (_herm(_global(b), uplo) @ zl if b is not None else zl)
        g = zg.mH @ zo - om
        out = _eigen_metrics(r, g, _sq(ah), k_rand, width, scale).cpu().numpy()
    else:
        # per column block of the probe: the squared norms of the random
        # columns' residual and Gram defect, and the largest sampled
        # column's squared residual; then the reference's three metrics
        ra, rz = _Ranks(a), _Ranks(z)
        z_t = rz.masked("G")
        blocks = ([(0, width, lambda dev, dt: torch.as_tensor(om_np).to(dev, dt))]
                  if mode != "full" else _blocks(n, None))
        fro2 = orth2 = colmax2 = None
        for j0, j1, make in blocks:
            om = rz.each(lambda r, c: make(rz.device(r, c), z.dtype))
            lam_om = rz.each(lambda r, c: torch.as_tensor(lam_np).to(
                rz.device(r, c), z.dtype)[:, None] * om[r][c])
            zo, zl = rz.mv(z_t, om, "N"), rz.mv(z_t, lam_om, "N")
            azo = ra.mv_herm(zo, uplo)
            bzl = _Ranks(b).mv_herm(zl, uplo) if b is not None else zl
            gg = rz.mv(z_t, zo, "C")
            rand = k_rand if mode != "full" else j1 - j0
            res = rz.each(lambda r, c: azo[r][c] - bzl[r][c])
            fro2 = rz.add(fro2, rz.each(lambda r, c: _sq(res[r][c][:, :rand])))
            orth2 = rz.add(orth2, rz.each(lambda r, c: _sq(gg[r][c][:, :rand]
                                                            - om[r][c][:, :rand])))
            colmax2 = rz.each(lambda r, c: _colmax2(res[r][c], rand, j1 - j0, colmax2, r, c))
        den2 = ra.herm_sq(uplo)

        def metrics(r, c):
            den = torch.sqrt(den2[r][c])
            den = torch.clamp(den, min=torch.finfo(den.dtype).tiny)
            return torch.stack([torch.sqrt(fro2[r][c]) * scale / den,
                                torch.sqrt(colmax2[r][c]) / den,
                                torch.sqrt(orth2[r][c]) * scale])

        from ..comm import collectives as cc

        out = cc.local_value(ra.each(metrics)).cpu().numpy()
    return {"eigen_residual": float(out[0]), "eigenpair_max": float(out[1]),
            "orthogonality": float(out[2])}


def array_orthogonality(q, mode: Optional[str] = None) -> float:
    """Orthogonality defect ``|Q^H Q - I|_F`` of a plain square tensor (or
    array), estimated per mode."""
    mode = resolved_mode(mode)
    q = torch.as_tensor(q)
    n = q.shape[0]
    if n == 0:
        return 0.0
    om_np, scale = _probe_columns(n, mode, DEFAULT_PROBES, PROBE_SEED)
    if om_np is None:
        g = q.mH @ q - torch.eye(n, dtype=q.dtype, device=q.device)
    else:
        om = _omega(om_np, q)
        g = q.mH @ (q @ om) - om
    return float(torch.sqrt(_sq(g)) * scale)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

def _platform_of(of=None) -> str:
    """The device type of the tensor holding the checked result (``of``: a
    tensor, a list of tensors or a Matrix), else ``"cpu"``."""
    if hasattr(of, "shards"):
        of = of.shards()
    if isinstance(of, (list, tuple)):
        of = next((x for x in of if isinstance(x, torch.Tensor)), None)
    return of.device.type if isinstance(of, torch.Tensor) else "cpu"


@dataclasses.dataclass
class AccuracyResult:
    """One emitted estimate: the value, its budget ``tol = c n eps`` (None
    for an informational metric) and ``bound_ratio = value / tol``."""

    site: str
    metric: str
    value: float
    finite: bool
    tol: Optional[float] = None
    bound_ratio: Optional[float] = None
    eps_eff: Optional[float] = None
    eps_label: str = ""

    @property
    def passed(self) -> bool:
        """Finite and within the budget (an informational metric passes on
        finiteness alone)."""
        return self.finite and (self.tol is None or self.value < self.tol)


def emit(site: str, metric: str, value, *, n: int, nb: int, dtype,
         c: Optional[float] = None, of=None, attrs: Optional[dict] = None,
         mode: Optional[str] = None, record: bool = True) -> AccuracyResult:
    """One ``accuracy`` record, its ``dlaf_accuracy_ratio{site,metric}``
    gauge (``dlaf_accuracy_nonfinite_total`` for a non-finite value) and,
    past the budget or non-finite, the flight recorder's
    ``accuracy_breach`` trigger; returns the :class:`AccuracyResult`.

    ``c`` is the site's tolerance factor (``tol = c * n * eps`` with
    :func:`..miniapp.checks.effective_eps`); ``c=None`` marks an
    informational metric (the D&C deflation fraction) with no
    ``bound_ratio``. A non-finite value lands as ``value: null`` with
    ``nonfinite: true``. ``record=False`` computes without emitting."""
    v = float(value)
    finite = math.isfinite(v)
    mode = resolved_mode(mode)
    tol = ratio = eps = None
    label = ""
    if c is not None:
        from ..miniapp.checks import effective_eps

        eps, label = effective_eps(dtype)
        tol = float(c) * max(int(n), 1) * eps
        if finite and tol > 0:
            ratio = v / tol
    rec = {"site": site, "metric": metric, "platform": _platform_of(of),
           "n": int(n), "nb": int(nb), "dtype": dtype_name(dtype),
           "value": v if finite else None, "attrs": dict(attrs or {}, mode=mode)}
    if not finite:
        rec["nonfinite"] = True
    if ratio is not None:
        rec["bound_ratio"] = ratio
        rec["c"] = float(c)
        rec["eps_eff"] = eps
    if record:
        from . import counter, emit_event, gauge, metrics_active
        from . import flight as _flight

        emit_event("accuracy", **rec)
        if metrics_active():
            if ratio is not None:
                gauge("dlaf_accuracy_ratio", site=site, metric=metric).set(ratio)
            if not finite:
                counter("dlaf_accuracy_nonfinite_total", site=site, metric=metric).inc()
        if (ratio is not None and ratio > 1.0) or not finite:
            # after the record, so the dump holds the breaching record
            _flight.trigger("accuracy_breach", site=site, metric=metric,
                            bound_ratio=float(ratio) if ratio is not None else None,
                            nonfinite=not finite)
    return AccuracyResult(site=site, metric=metric, value=v, finite=finite, tol=tol,
                          bound_ratio=ratio, eps_eff=eps, eps_label=label)


def b_orthogonality(uplo: str, b, z, mode: Optional[str] = None) -> float:
    """``|Z^H B Z - I|_F`` of the eigenvectors ``Z`` of a generalized
    problem (``B`` Hermitian from its ``uplo`` triangle), estimated per
    mode. The port's addition: its generalized eigensolver's check has
    held the B-orthogonality since it was ported, where the reference's
    check reads only the eigenpair residual."""
    mode = resolved_mode(mode)
    n = z.size.col
    if n == 0:
        return 0.0
    om_np, scale = _probe_columns(n, mode, DEFAULT_PROBES, PROBE_SEED)
    if _local(z):
        bh, zg = _herm(_global(b), uplo), _global(z)
        if om_np is None:
            g = zg.mH @ (bh @ zg) - torch.eye(n, dtype=zg.dtype, device=zg.device)
        else:
            om = _omega(om_np, zg)
            g = zg.mH @ (bh @ (zg @ om)) - om
        return float(torch.sqrt(_sq(g)) * scale)
    rb, rz = _Ranks(b), _Ranks(z)
    z_t = rz.masked("G")
    acc = None
    for _, _, make in _blocks(n, om_np):
        om = rz.each(lambda r, c: make(rz.device(r, c), z.dtype))
        gz = rz.mv(z_t, rb.mv_herm(rz.mv(z_t, om, "N"), uplo), "C")
        acc = rz.add(acc, rz.each(lambda r, c: _sq(gz[r][c] - om[r][c])))
    return rz.scalar(rz.each(lambda r, c: torch.sqrt(acc[r][c]) * scale))
