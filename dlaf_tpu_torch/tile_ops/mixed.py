"""Mixed-precision f64/complex128 panel factor: an f32 (complex64) seed
plus one Newton step.

Port of ``dlaf_tpu/tile_ops/mixed.py``:

* :func:`potrf_refined`: ``L32 = chol(f32(A))``, then
  ``L = L32 + L32 phi(Linv32 E Linv32^H)`` with ``E = A - L32 L32^H`` in
  f64 and ``phi`` the strict lower triangle plus half the diagonal.
* :func:`tri_inv_refined`: explicit ``L^-1`` from the f32 inverse plus one
  Newton step ``X <- X + X (I - L X)`` in f64.
* :func:`potrf_inv_refined`: both at once, sharing the seed's solves.

The seed uses ``torch.linalg.cholesky_ex`` and ``solve_triangular`` (the
reference uses ``lax.linalg``); a failed seed gives NaN from its failing
column on, as the reference's XLA factor does, instead of raising. The
Newton products are ``torch.matmul`` in f64.

Guard: the fast result is kept when it is finite and the seed's
conditioning estimate (:func:`cond_limit`) holds; otherwise the native f64
factor (and inverse) is taken. The reference's ``lax.cond`` runs only the
branch taken. Here the choice is a device-side ``torch.where`` over BOTH
branches, so no step waits on the host: the price is that the native f64
``cholesky_ex`` (and triangular solve) of the tile runs on every call,
taken or not.
"""

from __future__ import annotations

import torch

from .. import config
from .lapack import _chol_lower_nan

__all__ = ["potrf_refined", "potrf_inv_refined", "tri_inv_refined", "cond_limit"]


def cond_limit() -> float:
    """Limit on the squared diagonal ratio ``(max diag(L32) / min
    diag(L32))^2`` of the seed (config ``mixed_cond_limit``): blocks
    estimated worse take the native f64 factor."""
    return float(config.get_configuration().mixed_cond_limit)


def _seed_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex64 if dtype.is_complex else torch.float32


def _eye(n: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.eye(n, dtype=dtype or like.dtype, device=like.device)


def _lower_solve_eye(l: torch.Tensor, *, lower: bool = True) -> torch.Tensor:
    """``T^-1`` by a triangular solve of ``T X = I``."""
    return torch.linalg.solve_triangular(l, _eye(l.shape[-1], l), upper=not lower)


def _phi_lower(m: torch.Tensor) -> torch.Tensor:
    """Strict lower triangle plus half the (real part of the) diagonal."""
    d = torch.diagonal(m, dim1=-2, dim2=-1)
    d = d.real if m.is_complex() else d
    return torch.tril(m, -1) + torch.diag_embed((0.5 * d).to(m.dtype))


def _herm_from_tril(a: torch.Tensor) -> torch.Tensor:
    """Full Hermitian block from its stored lower triangle (real diagonal
    for complex dtypes)."""
    lo = torch.tril(a, -1)
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    d = d.real.to(a.dtype) if a.is_complex() else d
    return lo + lo.mH + torch.diag_embed(d)


def _diag_ratio_sq(tri32: torch.Tensor) -> torch.Tensor:
    """Squared max/min ratio of the seed factor's diagonal; non-positive or
    non-finite diagonals map to +inf."""
    d = torch.diagonal(tri32, dim1=-2, dim2=-1).abs()
    est = (d.max() / d.min()) ** 2
    good = torch.isfinite(est) & (d.min() > 0)
    return torch.where(good, est, torch.full_like(est, float("inf")))


def _chol_inv_seed_recursive(a: torch.Tensor, base: int):
    """(chol(a), chol(a)^-1) in the seed dtype by recursive 2x2 blocks:
    library calls at the ``base``-sized leaves, products above them."""
    n = a.shape[-1]
    if n <= base:
        l = _chol_lower_nan(a)
        return l, _lower_solve_eye(l)
    h = n // 2
    l11, i11 = _chol_inv_seed_recursive(a[:h, :h], base)
    l21 = a[h:, :h] @ i11.mH
    l22, i22 = _chol_inv_seed_recursive(a[h:, h:] - l21 @ l21.mH, base)
    i21 = -(i22 @ l21) @ i11
    l = torch.zeros_like(a)
    linv = torch.zeros_like(a)
    l[:h, :h], l[h:, :h], l[h:, h:] = l11, l21, l22
    linv[:h, :h], linv[h:, :h], linv[h:, h:] = i11, i21, i22
    return l, linv


def _refined_seed(a: torch.Tensor):
    """Seed factor and inverse, and the one-Newton-step refined factor:
    ``(refined_l, linv0, l32)``."""
    cfg = config.get_configuration()
    sd = _seed_dtype(a.dtype)
    if cfg.mixed_seed == "recursive":
        l32, linv32 = _chol_inv_seed_recursive(a.to(sd), int(cfg.mixed_seed_base))
    else:
        l32 = _chol_lower_nan(a.to(sd))
        linv32 = _lower_solve_eye(l32)
    l0 = torch.tril(l32).to(a.dtype)
    linv0 = torch.tril(linv32).to(a.dtype)
    e = a - l0 @ l0.mH
    m = (linv0 @ e) @ linv0.mH
    return l0 + l0 @ _phi_lower(m), linv0, l32


def _ok(l32: torch.Tensor, *fast: torch.Tensor) -> torch.Tensor:
    ok = _diag_ratio_sq(l32) <= cond_limit()
    for t in fast:
        ok = ok & torch.isfinite(t).all()
    return ok


def _potrf_refined_l(a: torch.Tensor) -> torch.Tensor:
    refined, _, l32 = _refined_seed(a)
    native = torch.tril(_chol_lower_nan(a))
    return torch.where(_ok(l32, refined), refined, native)


def potrf_refined(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """f64/complex128 Cholesky factor of the HPD block ``a`` (its ``uplo``
    triangle read; the other triangle of the result is zero): lower ``L``
    for 'L', upper ``U`` with ``U^H U = a`` for 'U'."""
    if uplo == "L":
        return _potrf_refined_l(_herm_from_tril(a))
    return _potrf_refined_l(_herm_from_tril(a.mH)).mH.resolve_conj()


def _potrf_inv_refined_l(a: torch.Tensor):
    n = a.shape[-1]
    l, linv0, l32 = _refined_seed(a)
    x = linv0 + linv0 @ (_eye(n, a) - l @ linv0)
    ln = torch.tril(_chol_lower_nan(a))
    xn = _lower_solve_eye(ln)
    ok = _ok(l32, l, x)
    return torch.where(ok, l, ln), torch.where(ok, x, xn)


def potrf_inv_refined(uplo: str, a: torch.Tensor):
    """(factor, explicit inverse) of the HPD block ``a``, sharing the seed's
    solves: ``(L, L^-1)`` lower for 'L', ``(U, U^-1)`` upper for 'U'."""
    if uplo == "L":
        return _potrf_inv_refined_l(_herm_from_tril(a))
    l, linv = _potrf_inv_refined_l(_herm_from_tril(a.mH))
    return l.mH.resolve_conj(), linv.mH.resolve_conj()


def tri_inv_refined(l: torch.Tensor, *, lower: bool = True) -> torch.Tensor:
    """Explicit f64 inverse of a triangular block: f32 solve + one Newton
    step; a non-finite or badly conditioned seed takes the native solve."""
    n = l.shape[-1]
    l32 = l.to(_seed_dtype(l.dtype))
    x32 = _lower_solve_eye(l32, lower=lower)
    tri = torch.tril if lower else torch.triu
    x0 = tri(x32).to(l.dtype)
    lt = tri(l)
    refined = x0 + x0 @ (_eye(n, l) - lt @ x0)
    native = _lower_solve_eye(lt, lower=lower)
    return torch.where(_ok(l32, refined), refined, native)
