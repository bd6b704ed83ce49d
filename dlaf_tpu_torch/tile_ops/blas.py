"""BLAS tile operations on torch.

Counterpart of ``dlaf_tpu/tile_ops/blas.py`` (reference ``blas/tile.h``),
cut to what the Cholesky, the triangular solve and multiply and HEGST
read. These are the composed route: plain ``torch.matmul``,
``torch.einsum`` and ``torch.linalg.solve_triangular``, the port's analog
of the reference's XLA route. The triangle a routine does not own passes through, as in
LAPACK. The f64/complex128 route decisions (``mm_mxu``,
``f64_gemm_uses_mxu``, ``trsm_panel_uses_mixed``, ``resolve_chunk_width``)
and the products and solves that follow them (``mm`` and through it
``gemm``, ``hemm``, ``her2k``, ``trmm``; ``herk``, ``contract``, the
recursive ``trsm``, ``trsm_panel``) live here too, as in the reference.
"""

from __future__ import annotations

import math

import torch

from .. import config


def _op(a: torch.Tensor, op: str) -> torch.Tensor:
    if op == "N":
        return a
    if op == "T":
        return a.transpose(-1, -2)
    if op == "C":
        return a.transpose(-1, -2).conj()
    raise ValueError(f"bad op {op!r}")


def tri_mask(a: torch.Tensor, uplo: str, *, k: int = 0) -> torch.Tensor:
    """Keep the stored triangle of the last-two-dims block."""
    if uplo == "G":
        return a
    if uplo == "L":
        return torch.tril(a, diagonal=k)
    if uplo == "U":
        return torch.triu(a, diagonal=-k)
    raise ValueError(f"bad uplo {uplo!r}")


def hermitian_from(a: torch.Tensor, uplo: str) -> torch.Tensor:
    """Full (conjugate-)symmetric block from its stored triangle; the
    diagonal's imaginary part is dropped for complex dtypes."""
    if uplo == "G":
        return a
    tri = tri_mask(a, uplo, k=-1)
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    if a.is_complex():
        d = d.real.to(a.dtype)
    return tri + tri.transpose(-1, -2).conj() + torch.diag_embed(d)


def _merge_triangle(update: torch.Tensor, orig: torch.Tensor, uplo: str) -> torch.Tensor:
    if uplo == "G":
        return update
    return tri_mask(update, uplo) + tri_mask(orig, "U" if uplo == "L" else "L", k=-1)


def gemm(a, b, c=None, *, alpha=1.0, beta=0.0, op_a: str = "N", op_b: str = "N"):
    """``alpha op_a(a) op_b(b) + beta c``; the product follows ``f64_gemm``
    (:func:`mm`)."""
    out = alpha * mm(_op(a, op_a), _op(b, op_b))
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(a.dtype)


def hemm(side: str, uplo: str, a, b, c=None, *, alpha=1.0, beta=0.0):
    """``alpha A b + beta c`` (side 'L') or ``alpha b A + beta c`` ('R')
    with Hermitian ``A`` stored in its ``uplo`` triangle; the product
    follows ``f64_gemm``."""
    af = hermitian_from(a, uplo)
    out = alpha * (mm(af, b) if side == "L" else mm(b, af))
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(b.dtype)


def herk(uplo: str, op_a: str, a, c, *, alpha=1.0, beta=1.0):
    """``alpha op_a(a) op_a(a)^H + beta c`` on the ``uplo`` triangle of
    ``c``; the other triangle passes through (alpha, beta real). Under
    ``f64_gemm="mxu"`` the gram is the Ozaki syrk (complex128: two syrks
    and one product), as the reference's ``herk``."""
    oa = _op(a, op_a)
    if _mxu_f64(oa, oa, (oa.shape[-2], oa.shape[-1])):
        from . import ozaki

        gram = ozaki.herk_c128 if oa.is_complex() else ozaki.syrk_f64
        prod = gram(oa, slices=_oz_slices())
    else:
        prod = oa @ oa.transpose(-1, -2).conj()
    upd = alpha * prod + beta * c
    if c.is_complex():  # herk guarantees a real diagonal
        d = torch.diagonal(upd, dim1=-2, dim2=-1)
        upd = upd - torch.diag_embed(d - d.real.to(upd.dtype))
    return _merge_triangle(upd, c, uplo)


def her2k(uplo: str, op: str, a, b, c, *, alpha=1.0, beta=1.0):
    """``alpha op(a) op(b)^H + conj(alpha) op(b) op(a)^H + beta c`` on the
    ``uplo`` triangle of ``c`` (beta real), the other triangle passed
    through; the one product follows ``f64_gemm``."""
    oa, ob = _op(a, op), _op(b, op)
    prod = alpha * mm(oa, ob.transpose(-1, -2).conj())
    prod = prod + prod.transpose(-1, -2).conj()
    return _merge_triangle(prod + beta * c, c, uplo)


def _tri(a: torch.Tensor, uplo: str, diag: str) -> torch.Tensor:
    """The ``uplo`` triangle of ``a``, its diagonal set to one for
    ``diag='U'``."""
    t = tri_mask(a, uplo)
    if diag == "U":
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        t = t - torch.diag_embed(torch.diagonal(t, dim1=-2, dim2=-1)) + eye
    return t


#: Triangles of a 2-D solve above this order split recursively
#: (:func:`_trsm_rec`) instead of going to one library solve: the bulk of
#: the flops become large products, which follow ``f64_gemm``.
TRSM_RECURSE_MIN = 2048


def _trsm_native(side, uplo, op_a, diag, a, b):
    t = tri_mask(a, uplo)
    upper = uplo == "U"
    if op_a != "N":
        t, upper = _op(t, op_a), not upper
    return torch.linalg.solve_triangular(t, b, upper=upper, left=side == "L",
                                         unitriangular=diag == "U")


def _trsm_rec(side, uplo, op_a, diag, a, b):
    """Recursive blocked solve: split ``A`` 2x2 at a 256-aligned half,
    solve the halves and connect them with one product (:func:`mm`); the
    leaves at most ``TRSM_RECURSE_MIN`` go to the library solve."""
    n = a.shape[-1]
    if n <= TRSM_RECURSE_MIN:
        return _trsm_native(side, uplo, op_a, diag, a, b)
    h = max(TRSM_RECURSE_MIN // 2, (n // 2) // 256 * 256)
    a11, a22 = a[:h, :h], a[h:, h:]
    # the off-diagonal block of op(A): for op 'N' the stored block on the
    # effective-lower side, otherwise the transpose of the other one
    eff_lower = (uplo == "L") == (op_a == "N")
    if eff_lower:
        s = a[h:, :h] if op_a == "N" else _op(a[:h, h:], op_a)
    else:
        s = a[:h, h:] if op_a == "N" else _op(a[h:, :h], op_a)
    if side == "L":
        if eff_lower:       # op(A) = [[T11, 0], [S, T22]]
            x1 = _trsm_rec(side, uplo, op_a, diag, a11, b[:h])
            x2 = _trsm_rec(side, uplo, op_a, diag, a22, b[h:] - mm(s, x1))
        else:               # op(A) = [[T11, S], [0, T22]]
            x2 = _trsm_rec(side, uplo, op_a, diag, a22, b[h:])
            x1 = _trsm_rec(side, uplo, op_a, diag, a11, b[:h] - mm(s, x2))
        return torch.cat([x1, x2], dim=0)
    if eff_lower:           # X [[T11, 0], [S, T22]] = [B1, B2]
        x2 = _trsm_rec(side, uplo, op_a, diag, a22, b[..., h:])
        x1 = _trsm_rec(side, uplo, op_a, diag, a11, b[..., :h] - mm(x2, s))
    else:                   # X [[T11, S], [0, T22]] = [B1, B2]
        x1 = _trsm_rec(side, uplo, op_a, diag, a11, b[..., :h])
        x2 = _trsm_rec(side, uplo, op_a, diag, a22, b[..., h:] - mm(x1, s))
    return torch.cat([x1, x2], dim=-1)


def trsm(side: str, uplo: str, op_a: str, diag: str, a, b, *, alpha=1.0):
    """Solve ``op_a(A) x = alpha b`` (side 'L') or ``x op_a(A) = alpha b``
    (side 'R') with the ``uplo`` triangle of ``a`` (unit diagonal for
    ``diag='U'``): ``torch.linalg.solve_triangular``, or for a 2-D
    triangle of order above ``TRSM_RECURSE_MIN`` the recursive blocked
    form (:func:`_trsm_rec`)."""
    out_dtype = b.dtype
    b = alpha * b
    if a.dim() == 2 and b.dim() == 2 and a.shape[-1] > TRSM_RECURSE_MIN:
        return _trsm_rec(side, uplo, op_a, diag, a, b).to(out_dtype)
    return _trsm_native(side, uplo, op_a, diag, a, b).to(out_dtype)


def trmm(side: str, uplo: str, op_a: str, diag: str, a, b, *, alpha=1.0):
    """``alpha op_a(A) b`` (side 'L') or ``alpha b op_a(A)`` ('R') with the
    ``uplo`` triangle of ``a`` (reference ``tile::trmm``); the product
    follows ``f64_gemm`` (:func:`mm`)."""
    t = _op(_tri(a, uplo, diag), op_a)
    prod = mm(t, b) if side == "L" else mm(b, t)
    return (alpha * prod).to(b.dtype)


# ---------------------------------------------------------------------------
# The f64/complex128 product route (reference blas.py:53-103, :362-426)
# ---------------------------------------------------------------------------

_F64 = (torch.float64, torch.complex128)


def _oz_slices() -> int:
    """Slice count of the Ozaki route: ``f64_gemm_slices``, 0 resolving
    to 8 (the reference's choice where f64 is native)."""
    return config.resolve_slices()


def mm_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` forced onto the Ozaki int8 slice route
    (:mod:`.ozaki`), whatever ``f64_gemm`` says: the product primitive of
    paths that are routed there by their own knob (the "ozaki" trailing
    route's panel application). Complex operands promote to complex128."""
    from . import ozaki

    if a.is_complex() or b.is_complex():
        return ozaki.matmul_c128(a.to(torch.complex128), b.to(torch.complex128),
                                 slices=_oz_slices())
    return ozaki.matmul_f64(a, b, slices=_oz_slices())


def f64_gemm_uses_mxu(dtype: torch.dtype, dim: int, device_type: str) -> bool:
    """Does ``f64_gemm`` route this dtype at block size ``dim`` onto the
    Ozaki route on ``device_type``? The knob and the ``f64_gemm_min_dim``
    gate are route policy (uncounted); ``health.inject.disable_ozaki``
    then closes an open route, the degradation counted at
    ``site="ozaki_gemm"`` (``DLAF_STRICT`` raises)."""
    if not (config.resolve("f64_gemm", device_type) == "mxu" and dtype in _F64
            and dim >= config.get_configuration().f64_gemm_min_dim):
        return False
    from ..health.registry import route_available

    return route_available("ozaki", "ozaki_gemm")


def trsm_panel_uses_mixed(dtype: torch.dtype, device_type: str) -> bool:
    """Does ``f64_trsm`` route this dtype's panels through the mixed
    f32-seed + Newton factor and inverse (:mod:`.mixed`)?"""
    return config.resolve("f64_trsm", device_type) == "mixed" and dtype in _F64


def _mxu_f64(a: torch.Tensor, b: torch.Tensor, dims) -> bool:
    """Does ``f64_gemm`` put this product on the Ozaki route? Both
    operands float64/complex128 and every dimension at least
    ``f64_gemm_min_dim`` (the reference's ``_mxu_f64``). Unlike the
    reference's, this tile gate also honours ``health.inject.disable_ozaki``
    (counted at ``site="ozaki_gemm"``, once a product), so that the drill
    closes the route for every product, not for the algorithm-level
    decisions only."""
    if not (config.resolve("f64_gemm", a.device.type) == "mxu"
            and a.dtype in _F64 and b.dtype in _F64
            and min(dims) >= config.get_configuration().f64_gemm_min_dim):
        return False
    from ..health.registry import route_available

    return route_available("ozaki", "ozaki_gemm")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the ``f64_gemm="mxu"`` reroute (the reference's
    ``_mm``). A stacked operand (a 3-D ``a`` against a 2-D ``b``, or the
    reverse) goes through ONE Ozaki product of the stacked rows (columns):
    the row and column scales are those of the per-tile products, so the
    result is the same."""
    if not _mxu_f64(a, b, (a.shape[-2], a.shape[-1], b.shape[-1])):
        return a @ b
    if a.dim() == 3 and b.dim() == 2:
        return mm_mxu(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:2], b.shape[-1])
    if a.dim() == 2 and b.dim() == 3:
        R, k, n = b.shape
        out = mm_mxu(a, b.permute(1, 0, 2).reshape(k, R * n))
        return out.reshape(a.shape[0], R, n).permute(1, 0, 2)
    return mm_mxu(a, b)


def contract(subscripts: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum with the ``f64_gemm="mxu"`` reroute (the
    reference's ``contract``). Natively ``torch.einsum``; on the Ozaki
    route the contraction is one 2-D product of the operands transposed
    to (free, contracted) and (contracted, free) and flattened, the form
    einsum lowers to. Labels shared by both operands contract and may not
    appear in the output (no batch labels), none repeats within an
    operand."""
    lhs, out = subscripts.split("->")
    s1, s2 = lhs.split(",")
    contracted = [c for c in s1 if c in s2]
    free1 = [c for c in s1 if c not in s2]
    free2 = [c for c in s2 if c not in s1]
    assert (len(set(s1)) == len(s1) and len(set(s2)) == len(s2)
            and not set(contracted) & set(out) and set(out) == set(free1 + free2)), subscripts
    d1, d2 = dict(zip(s1, x.shape)), dict(zip(s2, y.shape))
    f1 = math.prod(d1[c] for c in free1)
    f2 = math.prod(d2[c] for c in free2)
    kk = math.prod(d1[c] for c in contracted)
    if not _mxu_f64(x, y, (max(f1, 1), max(kk, 1), max(f2, 1))):
        return torch.einsum(subscripts, x, y)
    xf = x.permute([s1.index(c) for c in free1 + contracted]).reshape(f1, kk)
    yf = y.permute([s2.index(c) for c in contracted + free2]).reshape(kk, f2)
    full = mm_mxu(xf, yf).reshape([d1[c] for c in free1] + [d2[c] for c in free2])
    order = free1 + free2
    return full.permute([order.index(c) for c in out])


def resolve_chunk_width(knob: str, dtype: torch.dtype, gate_dim: int, chunk_axis: int,
                        device_type: str) -> int:
    """Width of a workspace-bounding chunk knob (``trsm_rhs_chunk``), or 0
    for unchunked, also when the width would not be shorter than
    ``chunk_axis``. 0 = off; an explicit width is raised to
    ``f64_gemm_min_dim`` where the Ozaki route is on at ``gate_dim`` (a
    narrower chunk would move its products off the route and change the
    numbers); -1 = auto, which chunks only on the reference's TPU (where
    its Ozaki workspaces ran out of memory), so never here."""
    cfg = config.get_configuration()
    width = getattr(cfg, knob)
    if width <= 0:
        return 0
    if f64_gemm_uses_mxu(dtype, gate_dim, device_type):
        width = max(width, cfg.f64_gemm_min_dim)
    return width if width < chunk_axis else 0


def trsm_panel(side: str, uplo: str, op_a: str, diag: str, a, b, *, alpha=1.0, inv_a=None):
    """``trsm`` of ONE triangular tile ``a`` against a possibly stacked
    rhs ``b`` (the distributed builders' per-tile panel solve). With
    ``f64_trsm="mixed"`` (float64/complex128) the solve is the refined
    explicit inverse (``inv_a`` when given, else :func:`..mixed.
    tri_inv_refined`) times :func:`mm`, which follows ``f64_gemm``;
    otherwise ``a`` broadcasts into the native solve."""
    if (trsm_panel_uses_mixed(a.dtype, a.device.type) and a.dim() == 2
            and b.dtype == a.dtype):
        from . import mixed as mx

        inv = inv_a if inv_a is not None else mx.tri_inv_refined(_tri(a, uplo, diag),
                                                                 lower=uplo == "L")
        ti = _op(inv, op_a)
        prod = mm(ti, b) if side == "L" else mm(b, ti)
        return (alpha * prod).to(b.dtype)
    return trsm(side, uplo, op_a, diag, a, b, alpha=alpha)


# ---------------------------------------------------------------------------
# Level-1/2 helpers (reference tile_extensions.h, GPU-internal blas/tile.h)
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor, *, alpha=1.0) -> torch.Tensor:
    """``b + alpha a`` (reference ``tile_extensions.h`` ``tile::add``)."""
    return b + alpha * a


def scal(a: torch.Tensor, *, alpha) -> torch.Tensor:
    """``alpha a``."""
    return alpha * a


def axpy(x: torch.Tensor, y: torch.Tensor, *, alpha=1.0) -> torch.Tensor:
    """``y + alpha x`` elementwise."""
    return y + alpha * x


def gemv(a: torch.Tensor, x: torch.Tensor, y=None, *, alpha=1.0, beta=1.0,
         op_a: str = "N") -> torch.Tensor:
    """``alpha op(A) x + beta y``; ``x``/``y`` vectors on the last axis,
    leading axes batch."""
    ax = torch.einsum("...ij,...j->...i", _op(a, op_a), x)
    return alpha * ax if y is None else alpha * ax + beta * y


def trmv(uplo: str, op_a: str, diag: str, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``op(T) x`` with ``T`` the ``uplo`` triangle of ``a`` (unit
    diagonal for ``diag="U"``)."""
    return torch.einsum("...ij,...j->...i", _op(_tri(a, uplo, diag), op_a), x)
