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
route's k x k coefficients) cross.

The Givens undo is one launch of the hand-written kernel of
:mod:`..tile_ops.givens_kernels` for the whole sequence (the reference
scans it on its device); the merge products go through ``blas.mm``, so
``f64_gemm=mxu`` puts them on the Ozaki route as in the reference.

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

Not ported now: the reference's sharded merges over a mesh (Q spread over
distinct devices past ``_SHARD_MERGE_MIN_N``). With a ``grid`` the merge
tree runs on rank (0, 0)'s device and Q is returned there; on a grid whose
ranks share one card that loses nothing. The reference's per-level
deflation records wait for the port of ``obs/accuracy.py``; ``stats``
takes their place for measurement.

Records (:mod:`..obs`): the ``tridiag_solver`` entry span with the
reference's merge flop model and attrs (``tridiag_solver.py:1007``;
``dc_level_batch`` and ``sharded`` are 0, the one schedule the port
runs), and ``dlaf_dc_merges_total{mode="serialized"}`` once per merge as
it runs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import config, obs
from ..algorithms.permutations import permute_array
from ..common.asserts import dlaf_assert
from ..tile_ops import blas as tb
from ..tile_ops import givens_kernels as gk
from ..tile_ops.lapack import stedc
from ..types import total_ops

_EPS = np.finfo(np.float64).eps


class MergeStats(NamedTuple):
    """One merge of a tree walk: its level (height above the leaves), size,
    deflated-problem size ``k``, Givens rotation count and secular route
    ("host", "device", or "decoupled")."""

    level: int
    n: int
    k: int
    rotations: int
    route: str


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
    ``native/secular.cpp`` (DLA-Future calls LAPACK laed4 here). A failed
    build raises; there is no fallback."""
    from ..native import bindings

    return bindings.secular_roots(ds, zs, rho)


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
    """The deflation scan by the native single pass; raises when the
    library cannot be built."""
    from ..native import bindings

    return bindings.deflate_scan(ds, zs, live, tol)


def _secular_vcols_device(ds: torch.Tensor, zs: torch.Tensor, rho: float):
    """Device twin of :func:`_secular_roots` plus the Gu-Eisenstat
    refinement and the eigenvector coefficients, in float64: ``ds``, ``zs``
    ``(k,)``. Returns ``(lam_live (k,), vcols (k, k))``; row ``i`` of
    ``vcols`` holds root ``i``'s normalized coefficients (reference
    ``tridiag_solver.py:161-214``, one lane). 300 halvings, the native
    solver's iteration cap: roots next to near-deflated poles sit about
    1e-28 gaps from their anchor."""
    k = ds.shape[0]
    zsq = zs * zs
    upper = torch.cat([ds[1:], (ds[-1] + rho * zsq.sum())[None]])
    gaps = upper - ds
    mid = ds + gaps / 2
    fmid = 1.0 + rho * (zsq[None, :] / (ds[None, :] - mid[:, None])).sum(-1)
    idx = torch.arange(k, device=ds.device)
    anchor = torch.where(fmid >= 0, idx, torch.clamp(idx + 1, max=k - 1))
    anchor[-1] = k - 1
    danchor = ds[anchor]
    own = anchor == idx
    lo = torch.where(own, torch.zeros_like(ds), ds - upper)
    hi = torch.where(own, gaps, torch.zeros_like(ds))
    delta = ds[None, :] - danchor[:, None]
    buf = torch.empty_like(delta)
    zsq2 = zsq[None, :]
    for _ in range(300):
        mu = 0.5 * (lo + hi)
        torch.sub(delta, mu[:, None], out=buf)
        torch.div(zsq2, buf, out=buf)
        f = 1.0 + rho * buf.sum(-1)
        take_left = f >= 0
        lo, hi = torch.where(take_left, lo, mu), torch.where(take_left, mu, hi)
    mu = 0.5 * (lo + hi)
    lam_live = danchor + mu
    m = delta.sub_(mu[:, None])                    # m[i, j] = d_j - lambda_i
    # the Gu-Eisenstat refinement as on the host: the logs of the ratios
    # |m[i, j]| / |d_j - d_i| (1 on the diagonal)
    torch.sub(ds[None, :], ds[:, None], out=buf)   # dd[i, j] = d_j - d_i
    buf.fill_diagonal_(1.0)
    torch.div(m, buf, out=buf)
    log_zhat2 = torch.log(torch.abs(buf, out=buf), out=buf).sum(0)
    del buf
    zhat = torch.sign(zs) * torch.exp(0.5 * log_zhat2)
    vcols = torch.div(zhat[None, :].expand_as(m), m, out=m)
    vcols /= torch.linalg.vector_norm(vcols, dim=-1, keepdim=True)
    return lam_live, vcols


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


def _assemble_qc(ctl: _MergeCtl, vcols, device) -> torch.Tensor:
    """The merge's ``(n, n)`` coefficient matrix ``qc`` on ``device``
    (reference ``_assemble_qc_impl``): the live poles' rows take the roots'
    coefficients (``vcols``, rows are roots), the deflated poles unit columns after
    them; the Givens rotations are undone on the rows (one launch); then
    the pole sort is undone on the rows and the final eigenvalue order
    applied to the columns, through :func:`permute_array`. The host holds
    no (n, n) array."""
    n, k = ctl.n, ctl.k
    u = torch.zeros((n, n), dtype=torch.float64, device=device)
    if k:
        u[_to(ctl.idx_live, device), :k] = vcols.T
    nd = n - k
    if nd:
        u[_to(ctl.idx_defl, device), _to(k + np.arange(nd), device)] = 1.0
    if ctl.gi.shape[0]:
        gk.givens_undo(u, _givens_undo_array(ctl))
    return permute_array("Col", ctl.fin, permute_array("Row", ctl.inv_order, u))


def _apply_qc_fn(q1: torch.Tensor, q2: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
    """The merge apply: ``blkdiag(q1, q2) @ qc``
    by two products through ``blas.mm`` (``f64_gemm`` routes them)."""
    n1 = q1.shape[0]
    return torch.cat([tb.mm(q1, qc[:n1]), tb.mm(q2, qc[n1:])], dim=0)


def _merge_apply(ctl: _MergeCtl, q1, q2, vcols_dev, use_device: bool, device):
    """Assembly and products of one merge: ``(lam, Q)``, Q on ``device``
    (numpy with ``use_device=False``: the reference's host loop)."""
    n1, n = ctl.n1, ctl.n
    if use_device:
        if ctl.decoupled:
            qc = permute_array("Col", ctl.fin,
                               torch.eye(n, dtype=torch.float64, device=device))
        else:
            if vcols_dev is None and ctl.k:
                vcols_dev = _to(ctl.vcols, device)
            qc = _assemble_qc(ctl, vcols_dev, device)
        return ctl.lam, _apply_qc_fn(q1, q2, qc)

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
    return ctl.lam, np.vstack([q1 @ qc[:n1, :], q2 @ qc[n1:, :]])


def _edge_z(q1, q2) -> np.ndarray:
    """The rank-one coupling vector: Q1's last row and Q2's first, on the
    host."""
    if isinstance(q1, torch.Tensor):
        return torch.cat([q1[-1], q2[0]]).cpu().numpy()
    return np.concatenate([q1[-1, :], q2[0, :]])


def _device_secular(ctl: _MergeCtl, device):
    """The device secular solve of one merge: its roots on the host and its
    ``(k, k)`` coefficients on the device."""
    lam, vcols = _secular_vcols_device(_to(ctl.dsk, device, torch.float64),
                                       _to(ctl.zsk, device, torch.float64), float(ctl.rho_n))
    return lam.cpu().numpy(), vcols


def _stat(stats, level: int, ctl: _MergeCtl) -> None:
    if stats is not None:
        route = ("decoupled" if ctl.decoupled else "device" if ctl.dev_secular else "host")
        stats.append(MergeStats(level, ctl.n, ctl.k if not ctl.decoupled else 0,
                                0 if ctl.decoupled else int(ctl.gi.shape[0]), route))


def _merge(node, res, use_device: bool, device, dev_min_k: int, stats=None):
    """One Cuppen merge, serialized (reference ``_merge``): host control,
    the secular solve on the host or (large k) the device, assembly and
    products."""
    (lam1, q1), (lam2, q2) = res[node.left], res[node.right]
    ctl = _merge_ctl_pre(lam1, lam2, _edge_z(q1, q2), node.rho, use_device, dev_min_k)
    obs.counter("dlaf_dc_merges_total", mode="serialized").inc()
    _stat(stats, node.height, ctl)
    vcols_dev = None
    if not ctl.decoupled:
        if ctl.dev_secular:
            lam_live, vcols_dev = _device_secular(ctl, device)
        else:
            lam_live = ctl.lam_live
        _merge_ctl_fin(ctl, lam_live)
    return _merge_apply(ctl, q1, q2, vcols_dev, use_device, device)


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


def _tridiag_dc(d, e, nb: int, use_device: bool, device, stats=None):
    """Bottom-up level-order walk of the merge tree, one merge at a time."""
    d_adj, leaves, levels, root = _merge_schedule(d, e, nb)
    dev_min_k = (config.resolve_secular_device_min_k(torch.device(device).type)
                 if use_device else 1 << 62)
    res = {}
    for leaf in leaves:
        lam, q = stedc(d_adj[leaf.off: leaf.off + leaf.n], e[leaf.off: leaf.off + leaf.n - 1])
        res[leaf] = (lam, _to(q, device, torch.float64) if use_device else q)
    for h in sorted(levels):
        for node in levels[h]:
            res[node] = _merge(node, res, use_device, device, dev_min_k, stats)
            del res[node.left], res[node.right]
    return res[root]


def tridiag_solver(d: np.ndarray, e: np.ndarray, nb: int, use_device: bool = True, *,
                   device=None, grid=None, stats: Optional[list] = None):
    """Eigenvalues (ascending, numpy) and eigenvectors of the real symmetric
    tridiagonal ``(d, e)`` by divide and conquer with leaves of at most
    ``nb`` (reference ``eigensolver::tridiagSolver``).

    With ``use_device=True`` the eigenvector matrix is a float64 tensor on
    ``device`` (default ``cuda``; with ``grid``, rank (0, 0)'s device, or
    on a multi-process grid the device of this process's rank),
    which holds Q for the whole merge tree. ``use_device=False`` returns
    numpy arrays (the reference's numpy twin).

    ``secular_device_min_k`` sets where the secular solve moves to the
    device. ``stats``, a list, receives one :class:`MergeStats` a
    merge."""
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
    # merge-product flop model: the sum over levels of 2^l (n/2^l)^3
    # multiplications and additions, (4/3) n^3 (deflation only lowers it)
    span = obs.entry_span("tridiag_solver", lambda: dict(
        flops=total_ops(np.float64, 2 * n ** 3 / 3, 2 * n ** 3 / 3), n=n, nb=nb,
        dc_level_batch=0, use_device=int(use_device), sharded=0))
    with span:
        return _tridiag_dc(d, e, nb, use_device, device, stats)
