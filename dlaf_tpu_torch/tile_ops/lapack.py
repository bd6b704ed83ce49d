"""LAPACK tile operations on torch: ``laset``, ``lacpy``, ``lange``,
``lantr``, ``potrf``, ``potrf_info``, ``hegst`` and ``larft``, and the host
solves ``laed4`` and ``stedc``.

Counterpart of ``dlaf_tpu/tile_ops/lapack.py``, the
reference's XLA route, so library calls are right here:
``torch.linalg.cholesky_ex`` and ``torch.linalg.solve_triangular``. The
factor lands in the ``uplo`` triangle and the opposite triangle of the
input passes through.

Failure contract (``potrf_info``'s NaN prefix): ``cholesky_ex`` does not
raise; it reports the first failing column in its ``info``. That column
and every later one are set to NaN, so the factor's diagonal is
non-finite from the first failing column on, as the reference's kernels
leave it, and :mod:`..health.info` reads the column back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import torch_dtype

from .blas import _merge_triangle, _tri, hermitian_from, tri_mask, trsm


def laset(uplo: str, alpha, beta, shape, dtype, device="cpu") -> torch.Tensor:
    """A new block: off-diagonal ``alpha``, diagonal ``beta``, over the
    ``uplo`` region, zero elsewhere (reference ``tile::laset``)."""
    m, n = shape[-2], shape[-1]
    tdt = torch_dtype(dtype)
    a = torch.full(tuple(shape), alpha, dtype=tdt, device=device)
    a = a + (beta - alpha) * torch.eye(m, n, dtype=tdt, device=device)
    return tri_mask(a, uplo)


def lacpy(uplo: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b`` with its ``uplo`` region (the whole block for "G") taken from
    ``a`` (reference ``tile::lacpy``); a new tensor."""
    if uplo == "G":
        return a.clone()
    return _merge_triangle(a, b, uplo)


def lange(norm: str, a: torch.Tensor) -> torch.Tensor:
    """Block norm (reference ``tile::lange``): "M" the largest modulus,
    "1" the largest column sum of moduli, "I" the largest row sum, "F"
    Frobenius; over the last two axes."""
    aa = a.abs()
    if norm == "M":
        return aa.amax(dim=(-2, -1)) if a.numel() else aa.new_zeros(a.shape[:-2])
    if norm == "1":
        return aa.sum(dim=-2).amax(dim=-1)
    if norm == "I":
        return aa.sum(dim=-1).amax(dim=-1)
    if norm == "F":
        return (aa * aa).sum(dim=(-2, -1)).sqrt()
    raise ValueError(f"bad norm {norm!r}")


def lantr(norm: str, uplo: str, diag: str, a: torch.Tensor) -> torch.Tensor:
    """Triangular-block norm (reference ``tile::lantr``): :func:`lange` of
    the ``uplo`` triangle, its diagonal one for ``diag="U"``."""
    return lange(norm, _tri(a, uplo, diag))


def laed4(d, z, rho: float) -> np.ndarray:
    """The roots of the secular equation of ``D + rho z z^T`` (reference
    ``tile::laed4``, LAPACK ``dlaed4``), ascending, on the host: the D&C
    merge's native solver (:func:`..native.bindings.secular_roots`) on
    ascending ``d``."""
    from ..native import bindings

    d = np.asarray(d, dtype=np.float64)
    anchor, offset = bindings.secular_roots(d, np.asarray(z, dtype=np.float64), float(rho))
    return d[anchor] + offset


def hegst(itype: int, uplo: str, a: torch.Tensor, b: torch.Tensor, *, solve=None):
    """The tile generalized-to-standard transform (reference
    ``tile::hegst``), ``itype=1``: ``inv(L) A inv(L)^H`` (uplo "L", ``b``
    holding L) or ``inv(U^H) A inv(U)`` ("U"), A read from its ``uplo``
    triangle; the result's ``uplo`` triangle is the transform and the
    opposite strict triangle is ``a``'s. ``solve(side, uplo, op, t, x)``
    does the two triangular solves (default :func:`.blas.trsm`; the
    blocked HEGST passes its panel route)."""
    if itype != 1:
        raise ValueError(f"hegst: itype {itype} is not used by the pipeline; only 1")
    if solve is None:
        def solve(side, up, op, t, x):
            return trsm(side, up, op, "N", t, x)
    return _merge_triangle(hegst_full(uplo, a, b, solve), a, uplo)


def hegst_full(uplo: str, a: torch.Tensor, b: torch.Tensor, solve) -> torch.Tensor:
    """:func:`hegst`'s two solves on the Hermitian ``a`` (read from its
    ``uplo`` triangle), unmerged: the whole tile, whose ``uplo`` triangle
    is the transform (for callers that read only that triangle)."""
    af = hermitian_from(a, uplo)
    if uplo == "L":
        return solve("R", "L", "C", b, solve("L", "L", "N", b, af))
    return solve("R", "U", "N", b, solve("L", "U", "C", b, af))


def _chol_lower_nan(af: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor with NaN from the first failing column on."""
    l, info = torch.linalg.cholesky_ex(af)
    n = af.shape[-1]
    cols = torch.arange(n, device=af.device)
    # info: 0 on success, else the 1-based order of the failing minor
    first = torch.where(info > 0, info - 1, n)
    bad = cols >= first[..., None]
    return torch.where(bad[..., None, :], torch.full_like(l, float("nan")), l)


def potrf(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of an SPD/HPD block stored in ``uplo``."""
    af = hermitian_from(a, uplo)
    f = _chol_lower_nan(af)
    if uplo == "L":
        return tri_mask(f, "L") + tri_mask(a, "U", k=-1)
    return tri_mask(f.transpose(-1, -2).conj(), "U") + tri_mask(a, "L", k=-1)


def potrf_info(uplo: str, a: torch.Tensor):
    """``(factor, info)``: info is 0 on success, else the 1-based first
    column whose diagonal is non-finite."""
    from ..health.info import bad_diag_mask, first_bad_info

    f = potrf(uplo, a)
    return f, first_bad_info(bad_diag_mask(torch.diagonal(f, dim1=-2, dim2=-1)))


def larft(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """T factor of a block of forward, columnwise Householder reflectors
    (reference ``tile::larft``): ``v`` (m, k), unit lower trapezoidal with
    the ones implicit (its upper triangle is not read), ``tau`` (k,).
    ``T^-1 = diag(1/tau) + strict_upper(V^H V)``, solved for T; a null
    reflector (``tau == 0``) gives a zero row and column of T, and its
    stored sub-diagonal is not read, as LAPACK's ``larft`` does."""
    k = tau.shape[-1]
    vlow = torch.where((tau == 0)[..., None, :], 0.0, tri_mask(v, "L", k=-1))
    vv = vlow + torch.eye(v.shape[-2], k, dtype=v.dtype, device=v.device)
    return t_from_gram(vv.mH @ vv, tau)


def t_from_gram(gram: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """T from the Gram matrix ``V^H V`` of the reflectors and their
    ``tau``: the triangular solve of :func:`larft` (and of the
    distributed T factor, whose Gram is a sum over ranks)."""
    k = tau.shape[-1]
    eye = torch.eye(k, dtype=gram.dtype, device=gram.device)
    tau_safe = torch.where(tau == 0, torch.ones_like(tau), tau)
    tinv = tri_mask(gram, "U", k=-1) + (1.0 / tau_safe)[..., :, None] * eye
    t = torch.linalg.solve_triangular(tinv, eye.expand(tinv.shape), upper=True)
    nz = tau != 0
    return torch.where(nz[..., :, None] & nz[..., None, :], t, 0.0)


def stedc(d: np.ndarray, e: np.ndarray):
    """Eigenvalues (ascending) and eigenvectors of the real symmetric
    tridiagonal ``(d, e)`` on the host in float64: the D&C tree's leaf
    solve (reference ``lapack.py:181-192``, ``scipy.linalg.eigh_tridiagonal``;
    DLA-Future's CPU leaves call LAPACK too)."""
    import scipy.linalg as sla

    d = np.asarray(d, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    if d.size == 1:
        return d.copy(), np.ones((1, 1))
    return sla.eigh_tridiagonal(d, e)
