"""Max-norm of a (triangular part of a) matrix, local or on a grid.

Port of ``dlaf_tpu/algorithms/norm.py`` (reference ``auxiliary::norm``,
``auxiliary/norm/mc.h:29-108``): per-rank partial maxima over each rank's
tiles, then a max all-reduce over grid rows and then grid columns, so
every rank holds the result. norm 'M' (largest absolute value) over uplo
'G' (the whole matrix) or 'L' (the lower triangle, the Hermitian case),
the reference's scope. A max of absolute values is exact, so the grid
form equals the local one bitwise. The absolute value of a complex entry
is the reference's (numpy's and XLA's), not torch's ``abs``, which can be
an ulp away from it: see :func:`_cabs`. Everything runs on the matrix's
device; only the maximum comes back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import collectives as cc
from ..comm.grid import COL_AXIS, ROW_AXIS
from ..common.asserts import dlaf_assert
from ..matrix.matrix import Matrix
from ..matrix.tiling import tiles_to_global


def _rank_mask(lt: torch.Tensor, rr: int, rc: int, dist, uplo: str) -> torch.Tensor:
    """The entries of one rank's shard ``lt`` (cycle positions ``rr``,
    ``rc``) the norm reads: padding tiles excluded, and for 'L' the
    strictly lower tiles plus the lower triangle of diagonal tiles (the
    reference's ``local_norm``, ``norm.py:38-56``)."""
    nt = dist.nr_tiles
    mb, nb = dist.block_size.row, dist.block_size.col
    P, Q = dist.grid_size.row, dist.grid_size.col
    g_rows = torch.arange(lt.shape[0], device=lt.device) * P + rr
    g_cols = torch.arange(lt.shape[1], device=lt.device) * Q + rc
    valid = (g_rows[:, None] < nt.row) & (g_cols[None, :] < nt.col)
    if uplo != "L":
        return valid[:, :, None, None].expand(lt.shape)
    keep_full = valid & (g_rows[:, None] > g_cols[None, :])
    keep_diag = valid & (g_rows[:, None] == g_cols[None, :])
    tril_m = torch.ones((mb, nb), dtype=torch.bool, device=lt.device).tril()
    return keep_full[:, :, None, None] | (keep_diag[:, :, None, None] & tril_m)


#: Dekker's splitting constants, 2^ceil(p/2) + 1 for precision p.
_SPLIT = {torch.float64: 2.0 ** 27 + 1, torch.float32: 2.0 ** 12 + 1}


def _fma_sq1(r: torch.Tensor) -> torch.Tensor:
    """``fma(r, r, 1)``, the correctly rounded ``1 + r*r``, for ``0 <= r
    <= 1`` from separately rounded operations: Dekker's split gives
    ``r*r = p + e`` exactly, ``1 + p = s + err`` exactly, and the sum of
    the two low parts decides the rounding of ``s`` only where ``s +
    err + e`` lies on a midpoint of ``s``'s neighbours."""
    one = torch.ones((), dtype=r.dtype, device=r.device)
    t = _SPLIT[r.dtype] * r
    rh = t - (t - r)
    rl = r - rh
    p = r * r
    e = ((rh * rh - p) + 2 * rh * rl) + rl * rl
    s = one + p
    err = p - (s - one)
    w = err + e                                  # TwoSum(err, e) = w + wl
    bv = w - err
    wl = (err - (w - bv)) + (e - bv)
    out = s + w
    up, dn = torch.nextafter(s, one * torch.inf), torch.nextafter(s, -one * torch.inf)
    tie_up, tie_dn = w == (up - s) / 2, w == (dn - s) / 2
    out = torch.where(tie_up & (wl > 0), up, torch.where(tie_up & (wl < 0), s, out))
    return torch.where(tie_dn & (wl < 0), dn, torch.where(tie_dn & (wl > 0), s, out))


def _sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root. torch's CPU ``sqrt`` (vectorized
    by its math library) is up to an ulp off it in about 0.5% of the
    entries, so a CPU tensor takes numpy's; CUDA's ``sqrt`` is the IEEE
    one."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.contiguous().numpy()))  # dlaf: disable=lint-np-in-traced(a CPU tensor only: the host's correctly rounded sqrt) # dlaf: disable=lint-host-sync(a CPU tensor only, no device to wait for)
    return torch.sqrt(v)


def _cabs(z: torch.Tensor) -> torch.Tensor:
    """Absolute values of a complex tensor as numpy and the reference's XLA
    compute them, bitwise: ``L * sqrt(fma(r, r, 1))`` with ``L = max(|re|,
    |im|)`` and ``r = min(|re|, |im|) / L``; 0 at 0, inf where a part is
    inf. (This is not the correctly rounded modulus: the two differ by an
    ulp in about a third of the entries.)"""
    x, y = z.real.abs(), z.imag.abs()
    big, small = torch.maximum(x, y), torch.minimum(x, y)
    zero = torch.zeros((), dtype=big.dtype, device=big.device)
    r = torch.where(big > 0, small / torch.where(big > 0, big, 1), zero)
    out = big * _sqrt_rn(_fma_sq1(r))
    return torch.where(torch.isinf(x) | torch.isinf(y), torch.inf, out)


#: Elements per step of a complex absolute value: bounds its temporaries.
_CHUNK = 1 << 24


def _masked_max_abs(x: torch.Tensor, mask=None) -> torch.Tensor:
    """``max |x|`` over the entries ``mask`` keeps (0 when none), as a
    0-d tensor on ``x``'s device; complex entries in chunks of
    :data:`_CHUNK` elements."""
    zero = torch.zeros((), dtype=x.real.dtype, device=x.device)
    if x.numel() == 0:
        return zero
    if not x.is_complex():
        return (x.abs() if mask is None else torch.where(mask, x.abs(), zero)).max()
    xf = x.reshape(-1)
    mf = None if mask is None else mask.reshape(-1)
    parts = []
    for c0 in range(0, xf.numel(), _CHUNK):
        v = _cabs(xf[c0:c0 + _CHUNK])
        parts.append((v if mf is None else torch.where(mf[c0:c0 + _CHUNK], v, zero)).max())
    return torch.stack(parts).max()


def max_norm(mat: Matrix, uplo: str = "G") -> float:
    """Largest absolute element of ``mat`` ('G') or of its lower triangle
    ('L')."""
    dlaf_assert(uplo in ("G", "L"), f"max_norm: uplo must be 'G' or 'L', got {uplo!r}")
    if mat.size.is_empty():
        return 0.0
    if not mat.distributed:
        a = tiles_to_global(mat.storage, mat.dist)
        if uplo == "L":
            a = torch.tril(a)
        return float(_masked_max_abs(a))
    dist = mat.dist
    P, Q = dist.grid_size.row, dist.grid_size.col
    sr, sc = dist.source_rank.row, dist.source_rank.col
    shards = mat.storage
    parts = cc.per_rank(P, Q, lambda r, c: _masked_max_abs(
        shards[r * Q + c], _rank_mask(shards[r * Q + c], (r - sr) % P, (c - sc) % Q, dist, uplo)))
    parts = cc.all_reduce(parts, ROW_AXIS, "max")
    parts = cc.all_reduce(parts, COL_AXIS, "max")
    return float(cc.local_value(parts))
