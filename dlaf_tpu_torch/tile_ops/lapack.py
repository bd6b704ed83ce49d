"""LAPACK tile operations on torch: ``potrf``, ``potrf_info`` and
``larft``, and the host leaf solve ``stedc``.

Counterpart of ``dlaf_tpu/tile_ops/lapack.py:71-99, 148-192``, the
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

from .blas import hermitian_from, tri_mask


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
