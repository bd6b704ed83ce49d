"""Panel Householder QR.

Port of ``dlaf_tpu/tile_ops/qr_panel.py``: ``panel_qr`` factors a panel in
``geqrf``'s output convention through ``torch.geqrf`` (LAPACK on the CPU,
cuSOLVER on the card), the reference's choice off its TPU. The column
Householder sweep :func:`householder_qr`, which the reference picks on
its TPU (where it has no geqrf), is ported in the same convention and
held against the reference's by the tests; no path of the port calls it.
Reduction to band is ``panel_qr``'s consumer; the T factor
(:mod:`..algorithms.qr`) takes reflectors already computed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["householder_qr", "panel_qr", "rebuild_q"]


def householder_qr(a: torch.Tensor):
    """Column Householder QR of the panel ``a`` (..., m, k), batched over
    leading dims, in ``geqrf``'s convention: R in the upper triangle (the
    real betas on the diagonal), the reflector tails below it, and
    ``taus`` (..., min(m, k)) with ``H_j = I - tau_j v_j v_j^H``,
    ``v_j[j] = 1``. LAPACK ``larfg``'s sign choice (``beta = -sign(Re
    alpha) ||x||``); a column with a zero tail (and, complex, a real
    diagonal) is a null reflector, ``tau = 0``; a wide panel (m < k)
    reduces min(m, k) columns. No rescaling against overflow of ``sum
    |x|^2``, as in the reference."""
    a = a.clone()
    m, k = a.shape[-2:]
    kk = min(m, k)
    cplx = a.is_complex()
    taus = a.new_zeros((*a.shape[:-2], kk))
    rows = torch.arange(m, device=a.device)
    for j in range(kk):
        col = a[..., :, j].clone()
        alpha = col[..., j]
        below = rows > j
        sigma = (torch.where(below, col, 0.0).abs() ** 2).sum(-1)
        alpha_r = alpha.real if cplx else alpha
        beta = (-torch.sign(torch.where(alpha_r == 0, 1.0, alpha_r))
                * torch.sqrt(alpha.abs() ** 2 + sigma)).to(a.dtype)
        null = (sigma == 0) & (alpha.imag == 0) if cplx else sigma == 0
        tau = torch.where(null, 0.0, (beta - alpha) / beta)
        scale = torch.where(null, 0.0, 1.0 / (alpha - beta))
        v = torch.where(below, col * scale[..., None], 0.0)
        v[..., j] = 1.0
        # apply H^H = I - conj(tau) v v^H to the trailing columns (LAPACK
        # geqr2 applies the adjoint reflector there and stores tau itself)
        if j + 1 < k:
            vha = (v.conj()[..., None, :] @ a[..., :, j + 1:])[..., 0, :]
            a[..., :, j + 1:] -= (tau.conj()[..., None, None] * v[..., :, None]
                                  * vha[..., None, :])
        a[..., j, j] = torch.where(null, alpha, beta)
        a[..., j + 1:, j] = torch.where(null[..., None], col[..., j + 1:],
                                        col[..., j + 1:] * scale[..., None])
        taus[..., j] = tau
    return a, taus


def rebuild_q(vfull, taus) -> np.ndarray:
    """Host (numpy) accumulation of the first ``k`` columns of ``Q = H_0
    H_1 ... H_{k-1}`` from stored reflectors: the verification oracle of
    the tests and ``chip_smoke.py``."""
    v = vfull.detach().cpu().numpy() if isinstance(vfull, torch.Tensor) else np.asarray(vfull)  # dlaf: disable=lint-host-sync(the host oracle of the tests and the chip script)
    taus = taus.detach().cpu().numpy() if isinstance(taus, torch.Tensor) else np.asarray(taus)  # dlaf: disable=lint-host-sync(the host oracle of the tests and the chip script)
    m, k = v.shape
    q = np.eye(m, k, dtype=v.dtype)
    for j in reversed(range(len(taus))):
        w = np.zeros(m, dtype=v.dtype)
        w[j] = 1.0
        w[j + 1:] = v[j + 1:, j]
        q -= taus[j] * np.outer(w, np.conj(w) @ q)
    return q


def panel_qr(a: torch.Tensor):
    """``(vfull, taus)`` of the panel ``a`` in ``geqrf``'s convention."""
    return torch.geqrf(a)
