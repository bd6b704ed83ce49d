"""Divide-and-conquer eigensolver of a real symmetric tridiagonal.

Port of ``dlaf_tpu/eigensolver/tridiag_solver.py`` (reference
``eigensolver/tridiag_solver``: Cuppen's method, split at tile boundaries,
``stedc`` leaf solves, bottom-up merges with a rank-one tear, deflation of
small weights and of near-equal poles by Givens rotations, the secular
equation per root, Gu-Eisenstat refinement of z, and the eigenvectors by
products).

Division of labour, as in the reference: the O(n) control of every merge
(tear normalization, pole sort, deflation scan, final order) runs on the
host in float64 numpy, line for line the reference's; the secular solve
with the z refinement runs on the host (the native ``secular.cpp``, the
laed4 analog, then numpy) below ``secular_device_min_k`` deflated poles
and on the device above it (float64 torch, the reference's 300-halving
bisection over a k x k array); the O(n^2) assembly of the merge's
coefficient matrix ``qc`` (scatters, the Givens undo, two permutations)
and the O(n^3) products ``blkdiag(Q1, Q2) @ qc`` run on the device, so Q
stays there for the whole merge tree and only O(n) vectors (and the host
route's k x k coefficients) cross. Where the native library of the
secular solver and the deflation scan cannot be built or loaded, their
numpy twins run, each degradation counted through :mod:`..health.registry`
at the reference's sites ``secular`` and ``deflate`` (``DLAF_STRICT``
raises).

The Givens undo is one launch of the hand-written kernel of
:mod:`..tile_ops.givens_kernels` for the whole sequence (the reference
scans it on its device), one per column shard of a sharded merge; the
merge products go through ``blas.mm``, so ``f64_gemm=mxu`` puts them on
the Ozaki route as in the reference.

The merge tree is walked level by level, one merge at a time (the
reference's serialized :func:`_merge`). The reference's level-batched walk,
which takes a level's same-shape device secular solves in one call, is not
ported: on the card it was within the spread of one call of the serialized
walk (PERF.md), and it would be a second path for the same result.

``use_device=False`` is the reference's numpy twin (host assembly loop and
numpy products), kept as the plain reference of the device path.

One repair against the reference: its Gu-Eisenstat refinement sums the
logs of the k pole-root distances and of the k-1 pole-pole distances of
each pole as two separate sums, of magnitude up to about 10 k each, that
cancel; their rounding left the eigenvectors of one merge of a random
order-2048 tridiagonal orthogonal only to 2.4e-10 (LAPACK's ``stemr`` on the
whole T: 1.6e-13), and the eigensolver's at N=16384 to 3.4e-9 on the card,
past ``200 n eps``. The port sums the logs of the ratios of the two
distances paired by root, the same formula: 1.9e-13 on that merge
(``tests/test_torch_tridiag_solver.py``). The roots, the tear and the
deflation are the reference's, line for line.

**Sharded merges** (reference ``_run_level`` under a mesh, ``:882-905``).
With a ``grid`` of several ranks, a merge of order ``_SHARD_MERGE_MIN_N``
(512) or more runs over all ``P*Q`` ranks (:func:`_merge_sharded`); the
leaves and the smaller merges run on rank (0, 0)'s device. The rule is the
reference's: shard whenever the grid has several ranks, also where they
share one card. That keeps one path, which the one-card ``chip_smoke.py``
drives, at the cost of the copies a shared card makes between ranks. The
layouts are the reference's contracts, in the port's own idiom (per-rank
tensors and explicit exchanges, no inserted SUMMA):

* the device secular solve runs row-sharded over the ranks (each rank
  bisects its roots), the roots' ``(anchor, mu)`` and the Gu-Eisenstat
  weights (column-sharded) crossing as O(k) vectors; the host route stays
  on the host of every process;
* ``qc`` is assembled column-sharded, rows replicated: rank (r, c) builds
  block r of grid column c's columns, directly in the final eigenvalue
  order (scatters, one Givens undo launch a column shard, the row
  permutation: all local); its coefficient rows come from the ranks that
  solved them by one exchange;
* Q comes out 2-D block-sharded (:class:`BlockQ`, contiguous row blocks by
  grid row, column blocks by grid column): each rank gathers its grid
  column's ``qc`` columns and the row panel of ``blkdiag(Q1, Q2)`` its grid
  row needs, and forms its block by ``blas.mm`` (the Ozaki route under
  ``f64_gemm=mxu``).

No rank forms the whole ``n x n`` Q or ``qc`` of a sharded merge: its
largest tensors are the ``n/P x n`` row panel and the ``n x n/Q`` column
block. In the multi-process form every process runs the O(n) control of a
sharded merge itself (the tridiagonal reaches every process first), and
an unsharded child's eigenvalues and edge rows cross from rank (0, 0)'s
process as one small object. The eigenvalues do not depend on the
sharding, bit for bit: a root's bisection reads only O(k) vectors, and
every sum over poles or roots is one row of an inner reduction, whose
order does not change with the rows beside it; the coupling vector ``z``
of each merge is its children's first and last eigenvector rows, formed
by such sums from their ``qc`` (:func:`_edge_row`), not read off a product
whose order depends on its blocking. The merge products do reassociate
with the blocking, so Q agrees with the unsharded solve's to rounding.

Records (:mod:`..obs`): the ``tridiag_solver`` entry span with the
reference's merge flop model and attrs (``tridiag_solver.py:1007``;
``dc_level_batch`` 0, the one schedule the port runs; ``sharded`` 1 on a
grid of several ranks), ``dlaf_dc_merges_total{mode="serialized"}`` once
per merge as it runs, and under ``DLAF_ACCURACY`` one ``accuracy`` record
a tree level of metric ``dc_deflation_fraction`` (the level, its merges,
merged and deflated poles in the attrs; rank (0, 0)'s process), the
reference's ``tridiag_solver.py:919-958``; ``stats`` keeps the same per
merge for measurement.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config, obs
from ..algorithms.permutations import permute_array
from ..comm import collectives as cc
from ..comm import multihost
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..common.index2d import GlobalElementSize
from ..matrix import tiling
from ..matrix.distribution import Distribution
from ..matrix.matrix import Matrix
from ..tile_ops import blas as tb
from ..tile_ops import givens_kernels as gk
from ..tile_ops.lapack import stedc
from ..types import total_ops

_EPS = np.finfo(np.float64).eps

#: Merges of at least this order run sharded over a grid of several ranks
#: (reference ``tridiag_solver.py:41``); smaller ones run on rank (0, 0)'s
#: device.
_SHARD_MERGE_MIN_N = 512

#: Columns a call of :func:`_edge_row` reduces at once (the last call takes
#: the rest, up to twice as many): never fewer than 16 where the merge has
#: them, so that a column's sum runs in one order whichever columns share
#: the call.
_EDGE_CHUNK = 1024


class MergeStats(NamedTuple):
    """One merge of a tree walk: its level (height above the leaves), size,
    deflated-problem size ``k``, Givens rotation count, secular route
    ("host", "device", or "decoupled") and the ranks it was sharded over
    (1: unsharded)."""

    level: int
    n: int
    k: int
    rotations: int
    route: str
    shards: int = 1


# ---------------------------------------------------------------------------
# Secular equation and deflation (reference tridiag_solver.py:98-278)
# ---------------------------------------------------------------------------

def _secular_roots(ds: np.ndarray, zs: np.ndarray, rho: float):
    """All k roots of ``1 + rho * sum z_j^2/(d_j - lam) = 0`` by vectorized
    bisection (numpy; the plain twin of the native solver). ``ds``
    ascending, ``zs`` nonzero, ``rho > 0``. Returns ``(anchor, offset)``:
    ``lambda_i = ds[anchor[i]] + offset[i]``, the anchor the nearest pole."""
    k = ds.shape[0]
    zsq = zs * zs
    upper = np.empty(k)
    upper[:-1] = ds[1:]
    upper[-1] = ds[-1] + rho * zsq.sum()
    gaps = upper - ds
    mid = ds + gaps / 2
    fmid = 1.0 + rho * (zsq[None, :] / (ds[None, :] - mid[:, None])).sum(1)
    anchor = np.where(fmid >= 0, np.arange(k), np.minimum(np.arange(k) + 1, k - 1))
    anchor[-1] = k - 1
    danchor = ds[anchor]
    lo = np.where(anchor == np.arange(k), 0.0, ds - upper)
    hi = np.where(anchor == np.arange(k), gaps, 0.0)
    lo = lo.copy()
    hi = hi.copy()
    delta = ds[None, :] - danchor[:, None]
    for _ in range(90):
        mu = 0.5 * (lo + hi)
        f = 1.0 + rho * (zsq[None, :] / (delta - mu[:, None])).sum(1)
        take_left = f >= 0
        hi = np.where(take_left, mu, hi)
        lo = np.where(take_left, lo, mu)
    mu = 0.5 * (lo + hi)
    return anchor, mu


def _secular_roots_host(ds, zs, rho):
    """The host secular solve: the native safeguarded Newton of
    ``native/secular.cpp`` (DLA-Future calls LAPACK laed4 here). When its
    library cannot be built or loaded, the numpy bisection
    :func:`_secular_roots` takes over through the degradation registry
    (``dlaf_fallback_total{site="secular"}``, announced once, a raise under
    ``DLAF_STRICT``), as the reference's site does."""
    from ..health.registry import run_with_fallback

    def _native():
        from ..native import bindings

        return bindings.secular_roots(ds, zs, rho)

    return run_with_fallback("secular", _native, lambda: _secular_roots(ds, zs, rho),
                             expected=RuntimeError)


def _deflation_scan_plain(ds, zs, live, tol):
    """Near-equal-pole deflation scan in Python (the plain twin of
    ``native/deflate.cpp``; reference ``merge.h:443-508``): rotate the z
    weight of live pole pairs closer than ``tol`` onto the earlier live
    pole, deflating the later one. Updates ``zs``/``live`` in place;
    returns the rotations ``(i, j, c, s)`` in application order."""
    gi, gj, gc, gs = [], [], [], []
    prev = -1
    for j in range(ds.shape[0]):
        if not live[j]:
            continue
        if prev >= 0 and ds[j] - ds[prev] <= tol:
            r = np.hypot(zs[prev], zs[j])
            if r == 0:
                prev = j
                continue
            gi.append(prev)
            gj.append(j)
            gc.append(zs[prev] / r)
            gs.append(zs[j] / r)
            zs[prev], zs[j] = r, 0.0
            live[j] = False
        else:
            prev = j
    return (np.asarray(gi, np.int64), np.asarray(gj, np.int64),
            np.asarray(gc, np.float64), np.asarray(gs, np.float64))


def _deflation_scan(ds, zs, live, tol):
    """The deflation scan by the native single pass; when its library
    cannot be built or loaded, :func:`_deflation_scan_plain` runs, the
    degradation counted at ``site="deflate"`` (a raise under
    ``DLAF_STRICT``), as the reference's site does."""
    try:
        from ..native import bindings

        return bindings.deflate_scan(ds, zs, live, tol)
    except RuntimeError as e:
        from ..health.registry import report_fallback

        report_fallback("deflate", "native_unavailable", exc=e)
    return _deflation_scan_plain(ds, zs, live, tol)


def _aligned(rows: int, m: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized ``(rows, m)`` tensor of ``like``'s dtype and device
    whose rows start 32-byte aligned (the row stride a multiple of four
    elements). A reduction over its rows then sums each row in one order,
    wherever the row sits: PyTorch's vectorized row sum on the card peels
    a row's misaligned head apart, so the order otherwise follows the
    row's address."""
    return torch.empty((rows, -(-m // 4) * 4), dtype=like.dtype, device=like.device)[:, :m]


def _secular_rows(ds: torch.Tensor, zs: torch.Tensor, rho: float, lo_row: int, hi_row: int):
    """Roots ``lo_row .. hi_row - 1`` of the secular equation on the device
    (float64; the device twin of :func:`_secular_roots`): ``(anchor, mu)``
    of those roots. Each root's bisection is independent and reads only
    the O(k) poles and weights, so any row range of roots is solved alone
    (the reference's row-sharded ``_secular_vcols_jit``). 300 halvings, the
    native solver's iteration cap: roots next to near-deflated poles sit
    about 1e-28 gaps from their anchor. Every sum over the poles is one
    row of an inner reduction over an aligned row (:func:`_aligned`), so a
    root takes the same bits whatever the row range (module docstring)."""
    k = ds.shape[0]
    zsq = zs * zs
    upper = torch.cat([ds[1:], (ds[-1] + rho * zsq.sum())[None]])
    gaps = (upper - ds)[lo_row:hi_row]
    d_r, up_r = ds[lo_row:hi_row], upper[lo_row:hi_row]
    mid = d_r + gaps / 2
    buf = _aligned(hi_row - lo_row, k, ds)
    torch.sub(ds[None, :], mid[:, None], out=buf)
    torch.div(zsq[None, :], buf, out=buf)
    fmid = 1.0 + rho * buf.sum(-1)
    idx = torch.arange(lo_row, hi_row, device=ds.device)
    anchor = torch.where(fmid >= 0, idx, torch.clamp(idx + 1, max=k - 1))
    anchor[idx == k - 1] = k - 1
    danchor = ds[anchor]
    own = anchor == idx
    lo = torch.where(own, torch.zeros_like(d_r), d_r - up_r)
    hi = torch.where(own, gaps, torch.zeros_like(d_r))
    delta = _aligned(hi_row - lo_row, k, ds)
    torch.sub(ds[None, :], danchor[:, None], out=delta)
    zsq2 = zsq[None, :]
    for _ in range(300):
        mu = 0.5 * (lo + hi)
        torch.sub(delta, mu[:, None], out=buf)
        torch.div(zsq2, buf, out=buf)
        f = 1.0 + rho * buf.sum(-1)
        take_left = f >= 0
        lo, hi = torch.where(take_left, lo, mu), torch.where(take_left, mu, hi)
    return anchor, 0.5 * (lo + hi)


def _secular_zhat(ds: torch.Tensor, zs: torch.Tensor, danchor: torch.Tensor, mu: torch.Tensor,
                  lo_col: int, hi_col: int) -> torch.Tensor:
    """The Gu-Eisenstat weights ``zhat_j`` of poles ``lo_col .. hi_col - 1``
    from every root's ``(danchor, mu)``: the logs of the ratios
    ``|d_j - lambda_i| / |d_j - d_i|`` (1 at i = j) summed over the roots,
    one row of an inner reduction per pole (the repair in the module
    docstring)."""
    cols = slice(lo_col, hi_col)
    w, k = hi_col - lo_col, ds.shape[0]
    m = _aligned(w, k, ds)
    torch.sub(ds[cols][:, None], danchor[None, :], out=m).sub_(mu[None, :])   # d_j - lambda_i
    dd = _aligned(w, k, ds)
    torch.sub(ds[cols][:, None], ds[None, :], out=dd)                          # d_j - d_i
    j = torch.arange(w, device=ds.device)
    dd[j, j + lo_col] = 1.0
    log_zhat2 = m.div_(dd).abs_().log_().sum(-1)
    return torch.sign(zs[cols]) * torch.exp(0.5 * log_zhat2)


def _secular_vcols_rows(ds: torch.Tensor, zhat: torch.Tensor, danchor: torch.Tensor,
                        mu: torch.Tensor) -> torch.Tensor:
    """The normalized eigenvector coefficients ``zhat_j / (d_j -
    lambda_i)`` of the roots ``(danchor, mu)``: one row a root."""
    m = _aligned(danchor.shape[0], ds.shape[0], ds)
    torch.sub(ds[None, :], danchor[:, None], out=m).sub_(mu[:, None])   # m[i, j] = d_j - lambda_i
    vcols = torch.div(zhat[None, :].expand_as(m), m, out=m)
    vcols /= torch.linalg.vector_norm(vcols, dim=-1, keepdim=True)
    return vcols


def _secular_vcols_device(ds: torch.Tensor, zs: torch.Tensor, rho: float):
    """Device twin of :func:`_secular_roots` plus the Gu-Eisenstat
    refinement and the eigenvector coefficients, in float64, for one
    device: ``ds``, ``zs`` ``(k,)``. Returns ``(lam_live (k,), vcols (k,
    k))``; row ``i`` of ``vcols`` holds root ``i``'s normalized
    coefficients (reference ``tridiag_solver.py:161-214``, one lane). A
    sharded merge runs the same three steps over row and column ranges
    (:func:`_sharded_secular`)."""
    k = ds.shape[0]
    anchor, mu = _secular_rows(ds, zs, rho, 0, k)
    danchor = ds[anchor]
    zhat = _secular_zhat(ds, zs, danchor, mu, 0, k)
    return danchor + mu, _secular_vcols_rows(ds, zhat, danchor, mu)


# ---------------------------------------------------------------------------
# Host control of one merge (reference tridiag_solver.py:477-675)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _MergeCtl:
    """Host control state of one Cuppen merge: :func:`_merge_ctl_pre`
    (sort, deflation, host secular solve or the device solve's inputs),
    then :func:`_merge_ctl_fin` (final order, pole-sort undo) once the
    roots exist. All fields are O(n) host arrays or scalars, but the host
    route's ``vcols`` (k, k)."""

    n1: int
    n2: int
    neg: bool
    decoupled: bool = False
    rho_n: float = 0.0
    order: np.ndarray = None
    ds: np.ndarray = None           # sorted (negated) poles, full n
    k: int = 0
    idx_live: np.ndarray = None
    idx_defl: np.ndarray = None
    gi: np.ndarray = None           # deflation Givens rotations
    gj: np.ndarray = None
    gc: np.ndarray = None
    gs: np.ndarray = None
    dsk: np.ndarray = None          # live poles/weights (secular inputs)
    zsk: np.ndarray = None
    dev_secular: bool = False       # secular solve deferred to the device
    vcols: np.ndarray = None        # host secular output (k, k)
    lam_live: np.ndarray = None     # host-route roots (ready after pre)
    lam: np.ndarray = None          # final ascending eigenvalues
    fin: np.ndarray = None
    inv_order: np.ndarray = None

    @property
    def n(self) -> int:
        return self.n1 + self.n2


def _merge_ctl_pre(lam1, lam2, z, rho_signed, use_device: bool, dev_min_k: int) -> _MergeCtl:
    """Phase 1 of a merge's host control (reference ``merge.h:443-629``):
    rank-one tear normalization, pole sort, deflation scan, and either the
    host secular solve with the Gu-Eisenstat refinement (k below
    ``dev_min_k``) or the device solve's inputs."""
    n1, n2 = lam1.shape[0], lam2.shape[0]
    d = np.concatenate([lam1, lam2])
    # rho < 0: solve the negated problem -T = diag(-d) + |rho| z z^T (the
    # LAPACK dlaed normalization)
    neg = rho_signed < 0
    rho = abs(rho_signed)
    if neg:
        d = -d
    ctl = _MergeCtl(n1=n1, n2=n2, neg=neg)
    znorm2 = float(z @ z)
    if rho * znorm2 <= 1e-300:  # fully decoupled
        lam = -d if neg else d
        fin = np.argsort(lam, kind="stable")
        ctl.decoupled = True
        ctl.lam = lam[fin]
        ctl.fin = fin
        return ctl
    zn = z / np.sqrt(znorm2)
    ctl.rho_n = rho_n = rho * znorm2
    order = np.argsort(d, kind="stable")
    ds, zs = d[order].copy(), zn[order].copy()
    ctl.order, ctl.ds = order, ds

    # -- deflation (reference merge.h:443-508) ------------------------------
    dmax = np.abs(ds).max(initial=0.0)
    tol = 8 * _EPS * max(dmax, 1.0)
    # dropping z_j perturbs the matrix by ~rho_n*|z_j|; deflate when that
    # is below eps * ||T|| (LAPACK dlaed2 criterion)
    live = rho_n * np.abs(zs) > 8 * _EPS * max(dmax, rho_n)
    ctl.gi, ctl.gj, ctl.gc, ctl.gs = _deflation_scan(ds, zs, live, tol)
    ctl.idx_live = np.nonzero(live)[0]
    ctl.idx_defl = np.nonzero(~live)[0]
    k = ctl.k = ctl.idx_live.shape[0]
    if k == 0:
        return ctl
    ctl.dsk = dsk = ds[ctl.idx_live]
    ctl.zsk = zsk = zs[ctl.idx_live]
    if use_device and k >= dev_min_k:
        ctl.dev_secular = True
        return ctl
    anchor, mu = _secular_roots_host(dsk, zsk, rho_n)
    ctl.lam_live = dsk[anchor] + mu
    # accurate pole-root differences: m[i, j] = d_j - lambda_i
    m = (dsk[None, :] - dsk[anchor][:, None]) - mu[:, None]
    # Gu-Eisenstat z refinement (reference laed4/dlaed3 step):
    # zhat_j^2 = prod_i |m[i, j]| / prod_{i != j} |d_j - d_i|, its logs
    # summed as the logs of the ratios paired by i (the repair in the
    # module docstring)
    dd = dsk[None, :] - dsk[:, None]
    np.fill_diagonal(dd, 1.0)
    log_zhat2 = np.log(np.abs(m / dd)).sum(0)
    zhat = np.sign(zsk) * np.exp(0.5 * log_zhat2)
    # eigenvector coefficients: v_i[j] = zhat_j / (d_j - lambda_i)
    vcols = (zhat[None, :] / m)
    vcols /= np.linalg.norm(vcols, axis=1, keepdims=True)
    ctl.vcols = vcols
    return ctl


def _merge_ctl_fin(ctl: _MergeCtl, lam_live) -> _MergeCtl:
    """Phase 2 of the host control: final ascending eigenvalue order and
    the pole-sort undo, from the host- or device-solved roots."""
    n, k = ctl.n, ctl.k
    lam = np.empty(n)
    if k == 0:
        lam[:] = ctl.ds
    else:
        lam[:k] = lam_live
        lam[k:] = ctl.ds[ctl.idx_defl]
    if ctl.neg:
        lam = -lam
    fin = np.argsort(lam, kind="stable")
    ctl.lam = lam[fin]
    ctl.fin = fin
    inv_order = np.empty(n, dtype=np.int64)
    inv_order[ctl.order] = np.arange(n)
    ctl.inv_order = inv_order
    return ctl


def _givens_undo_array(ctl: _MergeCtl) -> np.ndarray:
    """The merge's rotations as a ``(g, 4)`` array ``(i, j, c, s)`` in
    undo (reverse) order: the reference's ``_givens_padded`` without the
    identity padding (a launch takes any count)."""
    giv = np.empty((ctl.gi.shape[0], 4))
    giv[:, 0] = ctl.gi[::-1]
    giv[:, 1] = ctl.gj[::-1]
    giv[:, 2] = ctl.gc[::-1]
    giv[:, 3] = ctl.gs[::-1]
    return giv


# ---------------------------------------------------------------------------
# Assembly and products (reference tridiag_solver.py:281-402, 678-730)
# ---------------------------------------------------------------------------

def _to(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).to(device)


def _qc_columns(ctl: _MergeCtl, cols: np.ndarray, vrows, device) -> torch.Tensor:
    """Columns ``cols`` (final eigenvalue order) of the merge's
    coefficient matrix ``qc`` on ``device`` (reference
    ``_assemble_qc_impl``): column ``t`` is the sorted-space column
    ``fin[cols[t]]``, a live root's coefficients at the live poles' rows
    (``vrows``, one row per live column, in column order) or a deflated
    pole's unit vector; the Givens rotations are undone on its rows (one
    launch), then the pole sort is undone on the rows
    (:func:`permute_array`). Every step acts on each column alone, so a
    shard of columns is assembled without any other: the final column
    permutation is which columns a shard builds. The host holds no (n, n)
    array."""
    n, k = ctl.n, ctl.k
    w = cols.shape[0]
    u = torch.zeros((n, w), dtype=torch.float64, device=device)
    if ctl.decoupled:
        u[_to(ctl.fin[cols], device), _to(np.arange(w), device)] = 1.0
        return u
    src = ctl.fin[cols]
    live_t = np.nonzero(src < k)[0]
    defl_t = np.nonzero(src >= k)[0]
    if live_t.shape[0]:
        u[_to(ctl.idx_live, device)[:, None], _to(live_t, device)[None, :]] = vrows.T
    if defl_t.shape[0]:
        u[_to(ctl.idx_defl[src[defl_t] - k], device), _to(defl_t, device)] = 1.0
    if ctl.gi.shape[0]:
        gk.givens_undo(u, _givens_undo_array(ctl))
    return permute_array("Row", ctl.inv_order, u)


def _live_roots(ctl: _MergeCtl, cols: np.ndarray) -> np.ndarray:
    """The roots whose coefficients columns ``cols`` of ``qc`` take, in
    column order."""
    if ctl.decoupled:
        return np.zeros(0, dtype=np.int64)
    src = ctl.fin[cols]
    return src[src < ctl.k]


def _apply_qc_fn(q1: torch.Tensor, q2: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """The merge apply: ``blkdiag(q1, q2) @ qc``
    by two products through ``blas.mm`` (``f64_gemm`` routes them)."""
    n1 = q1.shape[0]
    return torch.cat([tb.mm(q1, qc[:n1]), tb.mm(q2, qc[n1:])], dim=0)


def _edge_row(vec: torch.Tensor, qc_part: torch.Tensor) -> torch.Tensor:
    """``vec @ qc_part``, one value per column, each an inner sum over
    ``qc_part``'s rows taken in chunks of at least 16 columns: the same
    bits for a column whichever columns share its call (module
    docstring). A merge's first and last eigenvector rows (its parent's
    rank-one coupling) are formed this way, not read off the product."""
    w = qc_part.shape[1]
    out, j = [], 0
    while j < w:
        e = w if w - j < 2 * _EDGE_CHUNK else j + _EDGE_CHUNK
        t = _aligned(e - j, qc_part.shape[0], qc_part)
        out.append(torch.mul(qc_part[:, j:e].T, vec[None, :], out=t).sum(-1))
        j = e
    return torch.cat(out) if out else qc_part.new_zeros(0)


def _edges(first1, last2, n1: int, qc: torch.Tensor, device):
    """The first and last rows of ``blkdiag(Q1, Q2) @ qc`` (columns of
    ``qc``) from Q1's first row and Q2's last."""
    return (_edge_row(_to(first1, device, torch.float64), qc[:n1]),
            _edge_row(_to(last2, device, torch.float64), qc[n1:]))


class _Res(NamedTuple):
    """One node's result: its eigenvalues (host), Q (a tensor on rank (0,
    0)'s device, None on the processes that do not drive it, or a
    :class:`BlockQ`) and Q's first and last rows (host; None at the root,
    and in the numpy twin, which reads them off Q)."""

    lam: np.ndarray
    q: object
    first: Optional[np.ndarray]
    last: Optional[np.ndarray]


def _merge_apply(ctl: _MergeCtl, a: _Res, b: _Res, vcols_dev, use_device: bool, device,
                 root: bool) -> _Res:
    """Assembly and products of one merge on one device: its result, Q on
    ``device`` (numpy with ``use_device=False``: the reference's host
    loop)."""
    n1, n = ctl.n1, ctl.n
    q1, q2 = a.q, b.q
    if use_device:
        cols = np.arange(n)
        vrows = None
        if ctl.k and not ctl.decoupled:
            live = _to(_live_roots(ctl, cols), device)
            vrows = (vcols_dev if vcols_dev is not None
                     else _to(ctl.vcols, device)).index_select(0, live)
        qc = _qc_columns(ctl, cols, vrows, device)
        del vrows
        first = last = None
        if not root:
            first, last = (x.cpu().numpy() for x in _edges(a.first, b.last, n1, qc, device))
        return _Res(ctl.lam, _apply_qc_fn(q1, q2, qc), first, last)

    if ctl.decoupled:
        qc = np.eye(n)[:, ctl.fin]
    else:
        k = ctl.k
        u_sorted = np.zeros((n, n))
        if k == 0:
            u_sorted[:] = np.eye(n)
        else:
            u_sorted[ctl.idx_live, :k] = ctl.vcols.T
            for t, j in enumerate(ctl.idx_defl):
                u_sorted[j, k + t] = 1.0
        # undo the Givens rotations (rows, reverse order)
        for i, j, c, s in zip(ctl.gi[::-1], ctl.gj[::-1], ctl.gc[::-1], ctl.gs[::-1]):
            ri = u_sorted[i].copy()
            rj = u_sorted[j].copy()
            u_sorted[i] = c * ri - s * rj
            u_sorted[j] = s * ri + c * rj
        qc = u_sorted[ctl.inv_order][:, ctl.fin]
    return _Res(ctl.lam, np.vstack([q1 @ qc[:n1, :], q2 @ qc[n1:, :]]), None, None)


def _stat(stats, level: int, ctl: _MergeCtl, shards: int = 1) -> None:
    if stats is not None:
        route = ("decoupled" if ctl.decoupled else "device" if ctl.dev_secular else "host")
        stats.append(MergeStats(level, ctl.n, ctl.k if not ctl.decoupled else 0,
                                0 if ctl.decoupled else int(ctl.gi.shape[0]), route, shards))


def _deflated(ctl: _MergeCtl) -> int:
    """Poles the merge deflated (all of a decoupled merge's): the
    reference's ``_log_deflation`` count."""
    return ctl.n if ctl.decoupled else ctl.n - ctl.k


def _merge(node, res, use_device: bool, device, dev_min_k: int, stats, log, root: bool) -> _Res:
    """One Cuppen merge on one device, serialized (reference ``_merge``):
    host control, the secular solve on the host or (large k) the device,
    assembly and products."""
    a, b = res[node.left], res[node.right]
    z = (np.concatenate([a.last, b.first]) if use_device
         else np.concatenate([a.q[-1, :], b.q[0, :]]))
    ctl = _merge_ctl_pre(a.lam, b.lam, z, node.rho, use_device, dev_min_k)
    if obs.metrics_active():
        obs.counter("dlaf_dc_merges_total", mode="serialized").inc()
    _stat(stats, node.height, ctl)
    log.append((ctl.n, _deflated(ctl)))
    vcols_dev = None
    if not ctl.decoupled:
        lam_live = ctl.lam_live
        if ctl.dev_secular:
            lam, vcols_dev = _secular_vcols_device(_to(ctl.dsk, device, torch.float64),
                                                   _to(ctl.zsk, device, torch.float64),
                                                   float(ctl.rho_n))
            lam_live = lam.cpu().numpy()
        _merge_ctl_fin(ctl, lam_live)
    return _merge_apply(ctl, a, b, vcols_dev, use_device, device, root)


# ---------------------------------------------------------------------------
# Sharded merges (reference tridiag_solver.py:218-235, 322-405, 882-905)
# ---------------------------------------------------------------------------

def _split(n: int, parts: int) -> list:
    """Bounds of ``parts`` contiguous blocks of ``n``: ``ceil(n / parts)``
    each, the last ones shorter (the even sharding of the reference's
    mesh)."""
    b = -(-n // parts)
    return [min(i * b, n) for i in range(parts + 1)]


class BlockQ:
    """An eigenvector matrix 2-D block-sharded over a grid (the
    reference's ``_q_2d_sharding``): rank ``(r, c)`` holds
    ``blocks[r][c]``, rows ``rows[r]:rows[r+1]`` by columns
    ``cols[c]:cols[c+1]``, on its device (None at the ranks other
    processes drive). No rank holds the whole matrix."""

    def __init__(self, grid, n: int, blocks):
        self.grid, self.n, self.blocks = grid, n, blocks
        self.rows = _split(n, grid.size.row)
        self.cols = _split(n, grid.size.col)

    def local_blocks(self) -> list:
        return [self.blocks[r][c] for r, c in self.grid.local_ranks]

    def to_global(self, device=None) -> torch.Tensor:
        """The whole matrix on ``device`` (default: rank (0, 0)'s), single
        controller only: for a checkpoint's payload and for tests."""
        dlaf_assert(not self.grid.multi_process, "BlockQ.to_global: single controller only")
        device = self.grid.device(0, 0) if device is None else device
        return torch.cat([torch.cat([b.to(device) for b in row], dim=1) for row in self.blocks])

    def to_matrix(self, block_size, source_rank) -> Matrix:
        """The block-cyclic :class:`~..matrix.matrix.Matrix` of the same
        values on the same grid (tiles ``block_size``, ``source_rank``),
        by one exchange between ranks: each rank receives, from each rank
        whose block its tiles overlap, the overlap only. The blocks are
        released as their pieces cross: the BlockQ is spent."""
        grid, n = self.grid, self.n
        P, Q = grid.size.row, grid.size.col
        dist = Distribution(GlobalElementSize(n, n), block_size, grid_size=grid.size,
                            source_rank=source_rank)
        _, _, ltr, ltc = tiling.storage_tile_grid(dist)
        mb, nb = block_size.row, block_size.col

        def local(r, c):
            i, j, mi, mj = tiling.shard_element_indices(dist, r, c, "cpu")
            i, j = i.long().numpy(), j.long().numpy()
            return (np.nonzero(mi.numpy())[0], i[mi.numpy()], np.nonzero(mj.numpy())[0],
                    j[mj.numpy()])

        where = {(r, c): local(r, c) for r in range(P) for c in range(Q)}

        def overlap(dst, src):
            pr, gr, pc, gc = where[dst]
            r0, r1 = self.rows[src[0]], self.rows[src[0] + 1]
            c0, c1 = self.cols[src[1]], self.cols[src[1] + 1]
            sr = (gr >= r0) & (gr < r1)
            sc = (gc >= c0) & (gc < c1)
            return pr[sr], gr[sr] - r0, pc[sc], gc[sc] - c0

        plan = {}
        for dst in where:
            plan[dst] = {}
            for src in where:
                _, rr, _, cc_ = overlap(dst, src)
                if rr.shape[0] and cc_.shape[0]:
                    plan[dst][src] = (rr.shape[0], cc_.shape[0])

        def give(src, dst):
            _, rr, _, cc_ = overlap(dst, src)
            blk = self.blocks[src[0]][src[1]]
            return blk.index_select(0, _to(rr, blk.device)).index_select(1, _to(cc_, blk.device))

        got = _exchange(grid, plan, give)
        self.blocks = None

        def tiles(r, c):
            dev = grid.device(r, c)
            dense = torch.zeros((ltr * mb, ltc * nb), dtype=torch.float64, device=dev)
            for src, piece in got[r][c].items():
                pr, _, pc, _ = overlap((r, c), src)
                dense[_to(pr, dev)[:, None], _to(pc, dev)[None, :]] = piece
            got[r][c] = None
            return dense.reshape(ltr, mb, ltc, nb).permute(0, 2, 1, 3).contiguous()

        nested = cc.per_rank(P, Q, tiles)
        return Matrix(dist, [s for row in nested for s in row], grid)


def shards_merges(grid, n: int) -> bool:
    """Does a D&C of order ``n`` on ``grid`` shard its merges (the grid
    has several ranks and the root merge is at least
    ``_SHARD_MERGE_MIN_N``)?"""
    return grid is not None and grid.num_devices > 1 and n >= _SHARD_MERGE_MIN_N


def _exchange(grid, plan: dict, give):
    """One exchange between the ranks of ``grid``: ``plan[(r, c)]`` maps
    each rank that sends rank ``(r, c)`` a float64 piece to its shape, and
    ``give(src, dst)`` forms the piece (called where ``src`` is driven).
    Returns per rank ``{source: piece}`` (:func:`..comm.collectives.
    exchange`)."""
    P, Q = grid.size.row, grid.size.col

    def sends(r, c):
        return {dst: give((r, c), dst) for dst, want in plan.items() if (r, c) in want}

    def expect(r, c):
        z = torch.empty((), dtype=torch.float64, device=grid.device(r, c))
        return {src: z.expand(shape) for src, shape in plan[(r, c)].items()}

    return cc.exchange(cc.per_rank(P, Q, sends), cc.per_rank(P, Q, expect))


def _receivers(grid, key) -> dict:
    """Per rank ``(r, c)``, the rank that receives for it: on a single
    controller the first rank (row-major) with its ``key(r, c)`` on its
    device, so that ranks which need the same piece and share a device
    read one copy of it; in the multi-process form every rank itself."""
    P, Q = grid.size.row, grid.size.col
    if grid.multi_process:
        return {(r, c): (r, c) for r in range(P) for c in range(Q)}
    first: dict = {}
    return {(r, c): first.setdefault((key(r, c), grid.device(r, c)), (r, c))
            for r in range(P) for c in range(Q)}


def _gather_host(grid, parts, lens) -> np.ndarray:
    """Every rank's 1-D float64 piece ``parts[r][c]`` (``lens[r][c]``
    long), joined in row-major rank order, on the host of every process
    (O(n): roots, weights and edge rows)."""
    P, Q = grid.size.row, grid.size.col
    if grid.multi_process:
        width = max(max(row) for row in lens)
        pad = cc.per_rank(P, Q, lambda r, c: torch.nn.functional.pad(
            parts[r][c], (0, width - lens[r][c])))
        full = cc.local_value(cc.all_gather(cc.all_gather(pad, COL_AXIS), ROW_AXIS)).cpu()
        parts = [[full[r, c] for c in range(Q)] for r in range(P)]
    return torch.cat([parts[r][c][:lens[r][c]].cpu() for r in range(P)
                      for c in range(Q)]).numpy()


def _holders(q, nq: int) -> list:
    """``(rank, row0, row1, col0, col1, block)`` of every block of a
    node's Q: a :class:`BlockQ`'s, or an unsharded Q whole at rank (0,
    0)."""
    if isinstance(q, BlockQ):
        P, Q = q.grid.size.row, q.grid.size.col
        return [((r, c), q.rows[r], q.rows[r + 1], q.cols[c], q.cols[c + 1], q.blocks[r][c])
                for r in range(P) for c in range(Q)]
    return [((0, 0), 0, nq, 0, nq, q)]


def _fetch_rows(grid, q, nq: int, span):
    """Per rank ``(r, c)``: rows ``span(r, c)`` (a ``(lo, hi)`` or None) of
    a node's Q, every column, on the rank's device, from the ranks that
    hold them; ranks with one span on one device share one copy
    (:func:`_receivers`) and only read it."""
    holders = {h[0]: h for h in _holders(q, nq)}
    P, Q = grid.size.row, grid.size.col
    recv = _receivers(grid, span)
    plan = {}
    for r in range(P):
        for c in range(Q):
            plan[(r, c)] = {}
            s = span(r, c) if recv[(r, c)] == (r, c) else None
            for src, r0, r1, c0, c1, _ in holders.values():
                if s and max(s[0], r0) < min(s[1], r1) and c1 > c0:
                    plan[(r, c)][src] = (min(s[1], r1) - max(s[0], r0), c1 - c0)

    def give(src, dst):
        _, r0, r1, _, _, blk = holders[src]
        lo, hi = span(*dst)
        return blk[max(lo, r0) - r0:min(hi, r1) - r0]

    got = _exchange(grid, plan, give)

    def join(r, c):
        if not span(r, c):
            return None
        parts = sorted(got[r][c].items(), key=lambda kv: (holders[kv[0]][1], holders[kv[0]][3]))
        rows = {}
        for src, piece in parts:
            rows.setdefault(holders[src][1], []).append(piece)
        return torch.cat([torch.cat(row, dim=1) for row in rows.values()], dim=0)

    return cc.per_rank_once(P, Q, lambda r, c: recv[(r, c)], lambda r, c: join(*recv[(r, c)]))


def _by_run(grid, span, fn):
    """``fn(device, lo, hi)`` once per run of consecutive ranks (rank-major)
    that this process drives on one device, over the union ``[lo, hi)`` of
    their ``span(r, c)``; each rank gets its rows of the result (a tensor,
    or a tuple of them, rows first). On a shared card the whole grid is one
    run; with a device per rank each rank is its own."""
    runs = []
    for r, c in grid.local_ranks:
        dev, (a, b) = grid.device(r, c), span(r, c)
        if runs and runs[-1][0] == dev and runs[-1][3] == a:
            runs[-1][1].append((r, c))
            runs[-1][3] = b
        else:
            runs.append([dev, [(r, c)], a, b])
    out = [[None] * grid.size.col for _ in range(grid.size.row)]
    for dev, ranks, lo, hi in runs:
        res = fn(dev, lo, hi)
        for r, c in ranks:
            a, b = span(r, c)
            out[r][c] = (tuple(x[a - lo:b - lo] for x in res) if isinstance(res, tuple)
                         else res[a - lo:b - lo])
    return out


def _sharded_secular(ctl: _MergeCtl, grid, shard_cols) -> tuple:
    """The device secular solve of a sharded merge: roots row-sharded over
    the ``P*Q`` ranks (rank-major), their ``(anchor, mu)`` gathered (O(k)),
    the Gu-Eisenstat weights column-sharded and gathered (O(k)), each
    rank's coefficient rows formed, then sent where the ``qc`` columns
    that take them are assembled. Returns ``(lam_live, vrows)``, the host
    roots and per rank the rows its columns ``shard_cols[(r, c)]`` take.
    The bisection of a root and the sum of a weight do not depend on the
    sharding, so the roots are bitwise the one-device solve's; ranks that
    share a device solve their rows together (:func:`_by_run`), one
    launch sequence for the device instead of one a rank."""
    P, Q = grid.size.row, grid.size.col
    k = ctl.k
    kb = _split(k, P * Q)

    def span(r, c):
        return kb[r * Q + c], kb[r * Q + c + 1]

    lens = [[span(r, c)[1] - span(r, c)[0] for c in range(Q)] for r in range(P)]
    devs = {grid.device(r, c) for r, c in grid.local_ranks}
    dsk = {d: _to(ctl.dsk, d, torch.float64) for d in devs}
    zsk = {d: _to(ctl.zsk, d, torch.float64) for d in devs}
    roots = _by_run(grid, span, lambda d, lo, hi: _secular_rows(dsk[d], zsk[d], float(ctl.rho_n),
                                                                lo, hi))
    anchor = _gather_host(grid, cc.per_rank(P, Q, lambda r, c: roots[r][c][0].double()),
                          lens).astype(np.int64)
    mu = _gather_host(grid, cc.per_rank(P, Q, lambda r, c: roots[r][c][1]), lens)
    del roots
    lam_live = ctl.dsk[anchor] + mu
    _merge_ctl_fin(ctl, lam_live)
    zhat = _gather_host(grid, _by_run(grid, span, lambda d, lo, hi: _secular_zhat(
        dsk[d], zsk[d], _to(ctl.dsk[anchor], d), _to(mu, d), lo, hi)), lens)
    vrows = _by_run(grid, span, lambda d, lo, hi: _secular_vcols_rows(
        dsk[d], _to(zhat, d), _to(ctl.dsk[anchor[lo:hi]], d), _to(mu[lo:hi], d)))
    need = {(r, c): _live_roots(ctl, np.arange(*shard_cols[(r, c)]))
            for r in range(P) for c in range(Q)}

    def owner_of(i):
        return divmod(int(np.searchsorted(kb, i, side="right")) - 1, Q)

    plan = {}
    for dst, roots_ in need.items():
        plan[dst] = {}
        for src in {owner_of(i) for i in roots_}:
            lo, hi = span(*src)
            plan[dst][src] = (int(((roots_ >= lo) & (roots_ < hi)).sum()), k)

    def give(src, dst):
        lo, hi = span(*src)
        sel = need[dst][(need[dst] >= lo) & (need[dst] < hi)] - lo
        rows = vrows[src[0]][src[1]]
        return rows.index_select(0, _to(sel, rows.device))

    got = _exchange(grid, plan, give)
    del vrows

    def place(r, c):
        roots_ = need[(r, c)]
        dev = grid.device(r, c)
        out = torch.empty((roots_.shape[0], k), dtype=torch.float64, device=dev)
        for src, piece in got[r][c].items():
            lo, hi = span(*src)
            out[_to(np.nonzero((roots_ >= lo) & (roots_ < hi))[0], dev)] = piece
        return out

    return lam_live, cc.per_rank(P, Q, place)


def _merge_sharded(node, res, grid, dev_min_k: int, stats, log, root: bool) -> _Res:
    """One merge sharded over ``grid``'s ``P*Q`` ranks (the reference's
    ``_run_level`` under a mesh): host control on every process; the
    device secular solve row-sharded; ``qc`` assembled column-sharded (rank
    ``(r, c)`` builds block ``r`` of grid column ``c``'s columns: its
    scatters, Givens undo and row permutation are local); the column
    blocks gathered along each grid column; then each rank forms its block
    of the 2-D block-sharded Q from the row panel of ``blkdiag(Q1, Q2)``
    its grid row needs and the ``qc`` columns its grid column needs, by
    ``blas.mm``. Ranks of one grid line that share a device read one copy
    of that panel and of those columns."""
    P, Q = grid.size.row, grid.size.col
    a, b = (_shared(grid, res[node.left]), _shared(grid, res[node.right]))
    ctl = _merge_ctl_pre(a.lam, b.lam, np.concatenate([a.last, b.first]), node.rho, True,
                         dev_min_k)
    if obs.metrics_active():
        obs.counter("dlaf_dc_merges_total", mode="serialized").inc()
    _stat(stats, node.height, ctl, P * Q)
    log.append((ctl.n, _deflated(ctl)))
    n, n1 = ctl.n, ctl.n1
    cb = _split(n, Q)
    shard_cols = {}
    for c in range(Q):
        sub = _split(cb[c + 1] - cb[c], P)
        for r in range(P):
            shard_cols[(r, c)] = (cb[c] + sub[r], cb[c] + sub[r + 1])
    vrows = cc.per_rank(P, Q, lambda r, c: None)
    if not ctl.decoupled:
        if ctl.dev_secular:
            _, vrows = _sharded_secular(ctl, grid, shard_cols)
        else:
            _merge_ctl_fin(ctl, ctl.lam_live)
            if ctl.k:
                vrows = cc.per_rank(P, Q, lambda r, c: _to(
                    ctl.vcols[_live_roots(ctl, np.arange(*shard_cols[(r, c)]))],
                    grid.device(r, c)))
    qc = cc.per_rank(P, Q, lambda r, c: _qc_columns(ctl, np.arange(*shard_cols[(r, c)]),
                                                     vrows[r][c], grid.device(r, c)))
    del vrows
    first = last = None
    if not root:
        lens = [[shard_cols[(r, c)][1] - shard_cols[(r, c)][0] for c in range(Q)]
                for r in range(P)]
        ed = cc.per_rank(P, Q, lambda r, c: _edges(a.first, b.last, n1, qc[r][c],
                                                   grid.device(r, c)))
        first = _gather_host(grid, cc.per_rank(P, Q, lambda r, c: ed[r][c][0]), lens)
        last = _gather_host(grid, cc.per_rank(P, Q, lambda r, c: ed[r][c][1]), lens)
        # the shards' columns in final order: block r of grid column c
        order = np.concatenate([np.arange(*shard_cols[(r, c)]) for r in range(P)
                                for c in range(Q)])
        first[order], last[order] = first.copy(), last.copy()
    # the qc columns of each grid column on each of its ranks: once per
    # device, where ranks of the column share one
    recv = _receivers(grid, lambda r, c: c)
    plan = {(r, c): {(i, c): (n, shard_cols[(i, c)][1] - shard_cols[(i, c)][0])
                     for i in range(P) if shard_cols[(i, c)][1] > shard_cols[(i, c)][0]}
            if recv[(r, c)] == (r, c) else {} for r in range(P) for c in range(Q)}
    got = _exchange(grid, plan, lambda src, dst: qc[src[0]][src[1]])
    del qc

    def cols(r, c):
        mine = got[r][c]
        return torch.cat([mine[(i, c)] for i in range(P) if (i, c) in mine], dim=1)

    qcols = cc.per_rank_once(P, Q, lambda r, c: recv[(r, c)], lambda r, c: cols(*recv[(r, c)]))
    del got
    rb = _split(n, P)
    top = _fetch_rows(grid, a.q, n1, lambda r, c: (rb[r], min(rb[r + 1], n1))
                      if rb[r] < n1 else None)
    bot = _fetch_rows(grid, b.q, n - n1, lambda r, c: (max(rb[r], n1) - n1, rb[r + 1] - n1)
                      if rb[r + 1] > n1 else None)

    def block(r, c):
        parts = []
        if top[r][c] is not None:
            parts.append(tb.mm(top[r][c], qcols[r][c][:n1]))
        if bot[r][c] is not None:
            parts.append(tb.mm(bot[r][c], qcols[r][c][n1:]))
        top[r][c] = bot[r][c] = qcols[r][c] = None
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    return _Res(ctl.lam, BlockQ(grid, n, cc.per_rank(P, Q, block)), first, last)


def _shared(grid, res: Optional[_Res]) -> _Res:
    """A child's result on every process: an unsharded child's eigenvalues
    and edge rows exist on rank (0, 0)'s process only and cross as one
    small object (its Q stays there, fetched by rows)."""
    if not grid.multi_process or (res is not None and isinstance(res.q, BlockQ)):
        return res
    owner = grid.is_local(0, 0)
    lam, first, last = multihost.broadcast_object(
        (res.lam, res.first, res.last) if owner else None, src=grid.process_rank(0, 0))
    return _Res(lam, res.q if owner else None, first, last)


# ---------------------------------------------------------------------------
# Merge tree (reference tridiag_solver.py:769-957)
# ---------------------------------------------------------------------------

class _TreeNode:
    """One node of the D&C split tree (host bookkeeping only)."""

    __slots__ = ("off", "n", "rho", "left", "right", "height")

    def __init__(self, off, n, rho=None, left=None, right=None, height=0):
        self.off, self.n, self.rho = off, n, rho
        self.left, self.right, self.height = left, right, height


def _merge_schedule(d, e, nb: int):
    """The recursive split at tile boundaries near the middle, with the
    pre-order tear adjustments of d: ``(d_adj, leaves, levels, root)``,
    ``levels[h]`` the merges at height ``h`` above the leaves (disjoint
    index ranges, children lower)."""
    d_adj = d.copy()
    leaves: list = []
    levels: dict = {}

    def build(off, n):
        if n <= max(nb, 2):
            node = _TreeNode(off, n)
            leaves.append(node)
            return node
        m = (n // 2 // nb) * nb
        if m == 0 or m == n:
            m = n // 2
        rho = e[off + m - 1]
        d_adj[off + m - 1] -= rho
        d_adj[off + m] -= rho
        left = build(off, m)
        right = build(off + m, n - m)
        node = _TreeNode(off, n, rho, left, right, 1 + max(left.height, right.height))
        levels.setdefault(node.height, []).append(node)
        return node

    root = build(0, d.shape[0])
    return d_adj, leaves, levels, root


def _tridiag_dc(d, e, nb: int, use_device: bool, device, stats=None, grid=None):
    """Bottom-up level-order walk of the merge tree, one merge at a time.
    With a grid of several ranks a merge of order ``_SHARD_MERGE_MIN_N``
    or more runs sharded (:func:`_merge_sharded`) on every process; the
    leaves and the smaller merges run on rank (0, 0)'s device, in the
    multi-process form on its process only. Under ``DLAF_ACCURACY`` each
    level emits its deflation fraction (rank (0, 0)'s process)."""
    from ..obs import accuracy

    shard = grid is not None and grid.num_devices > 1
    owner = grid is None or grid.is_local(0, 0)
    d_adj, leaves, levels, root = _merge_schedule(d, e, nb)
    dev_min_k = (config.resolve_secular_device_min_k(torch.device(device).type)
                 if use_device else 1 << 62)
    res = {}
    for leaf in leaves:
        if owner:
            lam, q = stedc(d_adj[leaf.off: leaf.off + leaf.n], e[leaf.off: leaf.off + leaf.n - 1])
            res[leaf] = _Res(lam, _to(q, device, torch.float64) if use_device else q,
                             q[0].copy(), q[-1].copy())
        else:
            res[leaf] = None
    collect = owner and accuracy.enabled()
    for h in sorted(levels):
        log = []
        for node in levels[h]:
            if shard and node.n >= _SHARD_MERGE_MIN_N:
                res[node] = _merge_sharded(node, res, grid, dev_min_k, stats, log,
                                           node is root)
            elif owner:
                res[node] = _merge(node, res, use_device, device, dev_min_k, stats, log,
                                   node is root)
            else:
                res[node] = None
            del res[node.left], res[node.right]
        if collect and log:
            merged = sum(m for m, _ in log)
            deflated = sum(k for _, k in log)
            accuracy.emit("tridiag_solver", "dc_deflation_fraction",
                          deflated / merged if merged else 0.0, n=d.shape[0], nb=nb, c=None,
                          dtype=np.float64, attrs={"level": h, "merges": len(log),
                                                   "merged_poles": merged,
                                                   "deflated_poles": deflated})
    return res[root]


def tridiag_solver(d: np.ndarray, e: np.ndarray, nb: int, use_device: bool = True, *,
                   device=None, grid=None, stats: Optional[list] = None):
    """Eigenvalues (ascending, numpy) and eigenvectors of the real symmetric
    tridiagonal ``(d, e)`` by divide and conquer with leaves of at most
    ``nb`` (reference ``eigensolver::tridiagSolver``).

    With ``use_device=True`` the eigenvector matrix is a float64 tensor on
    ``device`` (default ``cuda``), which holds Q for the whole merge tree.
    ``use_device=False`` returns numpy arrays (the reference's numpy twin).

    ``grid`` (the reference's ``mesh``): on a grid of several ranks the
    merges of order ``_SHARD_MERGE_MIN_N`` or more run sharded over its
    ranks (module docstring) and, where the root is one of them, Q is
    returned as a :class:`BlockQ`; otherwise Q is a tensor on rank (0,
    0)'s device. A multi-process grid's processes all call this: each
    receives the eigenvalues, and Q as its own blocks (a root that is not
    sharded: the tensor on rank (0, 0)'s process, None elsewhere).

    ``secular_device_min_k`` sets where the secular solve moves to the
    device. ``stats``, a list, receives one :class:`MergeStats` a
    merge (on every process)."""
    if grid is not None:
        dlaf_assert(use_device, "tridiag_solver: grid requires use_device=True")
        device = grid.device(*grid.local_ranks[0])
    device = torch.device("cuda" if device is None else device)
    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    n = d.shape[0]
    dlaf_assert(e.shape == (max(n - 1, 0),), f"tridiag_solver: e of shape {e.shape} for n={n}")
    if n == 0:
        return d, (torch.zeros((0, 0), dtype=torch.float64, device=device) if use_device
                   else np.zeros((0, 0)))
    sharded = grid is not None and grid.num_devices > 1
    # merge-product flop model: the sum over levels of 2^l (n/2^l)^3
    # multiplications and additions, (4/3) n^3 (deflation only lowers it)
    span = obs.entry_span("tridiag_solver", lambda: dict(
        flops=total_ops(np.float64, 2 * n ** 3 / 3, 2 * n ** 3 / 3), n=n, nb=nb,
        dc_level_batch=0, use_device=int(use_device), sharded=int(sharded)))
    with span:
        out = _tridiag_dc(d, e, nb, use_device, device, stats, grid if sharded else None)
        if not (sharded and grid.multi_process):
            return out.lam, out.q
        # the other processes: the eigenvalues where the root is not sharded,
        # and every merge's statistics, from rank (0, 0)'s process
        owner = grid.is_local(0, 0)
        lam, got = multihost.broadcast_object(
            (out.lam if out is not None else None, stats) if owner else None,
            src=grid.process_rank(0, 0))
        if stats is not None and not owner:
            stats[:] = got
        return lam, (out.q if out is not None else None)
