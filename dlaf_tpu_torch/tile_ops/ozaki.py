"""float64 and complex128 products through exact int8 slices (the Ozaki
scheme).

Port of ``dlaf_tpu/tile_ops/ozaki.py``. Each row of ``A`` (column of
``B``) is normalized to ``[-1/2, 1/2]`` by its max and peeled into ``s``
int8 slices of 7 bits; the slice pairs with total shift ``d = t + u < s``
are contracted exactly and folded with weight ``2^-7(d+2)``; the row and
column scales are applied last. ``s = 8`` keeps 56 mantissa bits.

Two routes, chosen by ``ozaki_impl`` (the reference's knob and values;
"auto" is "pallas" on ``cuda`` and "jnp" on ``cpu``):

* ``"jnp"`` (the reference's composed route, "dots" schedule): exact
  integer group sums, each as ONE float64 product of the K-concatenated
  slices (every partial sum is an integer below 2^53, so the product is
  exact whatever the library's summation order), folded in float64 in the
  order d = 0 .. s-1. Bitwise the reference's jnp route.
* ``"pallas"``: contractions with K <= 1024 go through the hand-written
  slice kernels of :mod:`.ozaki_kernels` (double-f32 fold, about 48
  mantissa bits), then ``hi + lo`` in float64, the syrk's mirror and the
  scales, as ``ozaki.py:299-308`` and ``:376-388`` do. Deeper
  contractions stay on "jnp". ``tri="L"``/``"U"`` skips the syrk's mirror
  for a caller that reads only one triangle (the Cholesky trailing
  update), which saves two passes over the (m, m) float64 plane.

The peel matches the reference bit for bit: ``torch.round`` (half to
even) of the float32 cast of ``r 2^7(t+1)``, and the residual subtracts
the STORED int8 value. Inputs are 2-D; finite inputs only, as in the
reference. Complex128 products are composed of four real products
(:func:`matmul_c128`) and Hermitian grams of two syrks and one product
(:func:`herk_c128`).
"""

from __future__ import annotations

import torch

from .. import config
from . import ozaki_kernels as ok

__all__ = ["matmul_f64", "syrk_f64", "matmul_c128", "herk_c128", "DEFAULT_SLICES",
           "SLICE_BITS"]

SLICE_BITS = ok.SLICE_BITS
DEFAULT_SLICES = 8


def _scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-row (``dim=-1``) or per-column (``dim=-2``) max ``|x|``, zero
    rows mapping to 1, kept as a broadcastable dimension."""
    m = x.abs().amax(dim=dim, keepdim=True)
    return torch.where(m > 0, m, torch.ones_like(m))


def _normalize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x / scale) * 0.5``, in ``[-1/2, 1/2]``; the ``* 0.5`` is exact."""
    return (x / scale) * 0.5


def _peel_slices(xn: torch.Tensor, s: int) -> list:
    """``s`` int8 slices with ``xn ~= sum_t I_t 2^-7(t+1)``: the integer is
    the half-to-even round of the float32 cast of ``r 2^7(t+1)``, and the
    residual subtracts the stored slice (through float32, exact), as
    ``ozaki.py:109-119`` does."""
    out = []
    r = xn
    for t in range(s):
        sc = float(2.0 ** (SLICE_BITS * (t + 1)))
        it8 = torch.round((r * sc).float()).to(torch.int8)
        out.append(it8)
        if t + 1 < s:
            r = r - it8.float().to(xn.dtype) * (1.0 / sc)
    return out


def _apply_scales(acc: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """``((acc * 4) * sa) * sb`` in place: the ``* 4`` folds back the two
    halvings of :func:`_normalize`; the scales come last so nothing
    overflows unless the true result does."""
    return acc.mul_(4.0).mul_(sa).mul_(sb)


def _use_kernels(k: int, device_type: str) -> bool:
    return config.resolve("ozaki_impl", device_type) == "pallas" and k <= ok.K_MAX


def _composed(ia, ib_rows, shape, device) -> torch.Tensor:
    """The "jnp" route: exact group sums folded in float64."""
    acc = torch.zeros(shape, dtype=torch.float64, device=device)
    for d, p in ok.group_sums(torch.stack(ia), torch.stack(ib_rows)):
        acc.add_(p.mul_(2.0 ** (-SLICE_BITS * (d + 2))))
    return acc


def matmul_f64(a: torch.Tensor, b: torch.Tensor, *, slices: int = DEFAULT_SLICES):
    """``a @ b`` for real float64 2-D ``a`` (m, k) and ``b`` (k, n)
    through int8 slices; ``s(s+1)/2`` slice products, accuracy
    ``~2^-7s`` relative to ``rowmax(a) colmax(b)``."""
    s = int(slices)
    sa = _scale(a, -1)
    sb = _scale(b, -2)
    ia = _peel_slices(_normalize(a, sa), s)
    ib = _peel_slices(_normalize(b, sb), s)
    if _use_kernels(a.shape[-1], a.device.type):
        hi, lo = ok.ozaki_product(torch.stack(ia), torch.stack(ib))
        acc = hi.double().add_(lo)
    else:
        acc = _composed(ia, [x.mT for x in ib], (a.shape[0], b.shape[1]), a.device)
    return _apply_scales(acc, sa, sb)


def syrk_f64(a: torch.Tensor, *, slices: int = DEFAULT_SLICES, tri=None):
    """``a @ a.T`` for real float64 2-D ``a`` through int8 slices, peeled
    once; symmetric. With ``tri="L"`` or ``"U"`` only that triangle is the
    gram's, bitwise the mirrored gram's there: no mirror is formed, and the
    upper triangle is the kernels' lower one read transposed (a view)."""
    s = int(slices)
    sa = _scale(a, -1)
    ia = _peel_slices(_normalize(a, sa), s)
    m = a.shape[0]
    if _use_kernels(a.shape[-1], a.device.type):
        hi, lo = ok.ozaki_syrk(torch.stack(ia))
        acc = hi.double().add_(lo)
        del hi, lo
        if tri is None:
            # the kernel's lower blocks hold the gram; mirror the strict
            # lower triangle (tril(acc) + tril(acc, -1)^T, as the reference)
            full = torch.tril(acc)
            full.add_(torch.tril(acc, -1).mT)
            acc = full
        elif tri == "U":
            # scaled below in the mirrored gram's order, element by element
            acc = acc.mT
    else:
        acc = _composed(ia, ia, (m, m), a.device)
    return _apply_scales(acc, sa, sa.mT)


def matmul_c128(a: torch.Tensor, b: torch.Tensor, *, slices: int = DEFAULT_SLICES):
    """``a @ b`` for complex128 2-D inputs from four real
    :func:`matmul_f64` products (the reference's 4-product form, with the
    native overflow and error profile)."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    re = matmul_f64(ar, br, slices=slices) - matmul_f64(ai, bi, slices=slices)
    im = matmul_f64(ar, bi, slices=slices) + matmul_f64(ai, br, slices=slices)
    return torch.complex(re, im)


def herk_c128(a: torch.Tensor, *, slices: int = DEFAULT_SLICES, tri=None):
    """``a @ a^H`` for complex128 2-D ``a``: two real syrks for the real
    part, one real product (and its transpose) for the imaginary part.
    ``tri`` as for :func:`syrk_f64`."""
    ar, ai = a.real, a.imag
    re = syrk_f64(ar, slices=slices, tri=tri)
    re.add_(syrk_f64(ai, slices=slices, tri=tri))
    m = matmul_f64(ai, ar.mT, slices=slices)
    return torch.complex(re, m - m.mT)
