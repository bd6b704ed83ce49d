"""Band to tridiagonal by bulge chasing (a host stage).

Counterpart of ``dlaf_tpu/eigensolver/band_to_tridiag.py:41-199`` (reference
``eigensolver/band_to_tridiag``, ``api.h:39-46``, ``mc.h:91-380``): like the
reference, and like DLA-Future itself, which runs this stage on the CPU
even for its GPU backend, the sequential fine-grained chase runs on the
host, on compact band storage with bulge headroom (``ld = 2b+1``), and
returns numpy arrays.

Sweep ``s`` eliminates column ``s`` below the first subdiagonal with a
length-``b`` Householder reflector, then chases the bulge down the band in
contiguous length-``b`` chunks. The chase segments of one sweep are
disjoint row ranges ``[s+1+t*b, s+1+(t+1)*b)``, so a sweep's reflectors
commute, and they are returned in a dense uniform layout:

    V[s, t, :]   the reflector of sweep s, chase step t (v[0] = 1, zero-padded)
    TAU[s, t]    its tau (0 => identity)

The chase is the C++ one of ``native/band_to_tridiag.cpp`` (the port's
own copy, built at first use). When its library cannot be built or
loaded, the reference's numpy chase (:func:`band_to_tridiag_numpy`, kept
as this fallback only) runs instead, the degradation counted through
:mod:`..health.registry` at ``site="band_to_tridiag"`` (a raise under
``DLAF_STRICT``), as in the reference.

Complex matrices: the chase leaves a Hermitian tridiagonal with complex
off-diagonals; it is phase-normalized to a REAL symmetric tridiagonal
(LAPACK ``hbtrd``'s convention), with the unit phases returned so that the
back-transform can restore them (``T_complex = Phi T_real Phi^H``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import ceil_div


@dataclasses.dataclass
class TridiagResult:
    """Reference ``TridiagResult{mat_trid, mat_v}`` analog (``api.h:19``)."""

    d: np.ndarray        # (n,) real diagonal
    e: np.ndarray        # (n-1,) real off-diagonal
    v: np.ndarray        # (n_sweeps, n_steps, b) reflectors
    tau: np.ndarray      # (n_sweeps, n_steps)
    phase: np.ndarray    # (n,) unit phases (ones for real dtypes)
    band: int


_ARRAYS = ("d", "e", "v", "tau", "phase")


def share_tridiag(tri, grid) -> TridiagResult:
    """The chase's result, formed by the process of rank (0, 0) alone
    (``tri`` there, None on the others), on every process of ``grid``'s
    multi-process world, bit for bit: the arrays' shapes and dtypes cross
    by ``multihost.broadcast_object``, the arrays themselves (the
    reflectors are O(n^2 / 2)) by the transport's broadcast
    (``cc.bcast_arrays``). ``tri`` itself without such a world."""
    from ..comm import collectives as cc
    from ..comm import multihost

    if grid is None or not grid.multi_process:
        return tri
    specs = None if tri is None else (
        [(getattr(tri, f).shape, getattr(tri, f).dtype) for f in _ARRAYS], tri.band)
    specs, band = multihost.broadcast_object(specs, src=grid.process_rank(0, 0))
    got = cc.bcast_arrays(None if tri is None else [getattr(tri, f) for f in _ARRAYS], 0, 0,
                          specs)
    return tri if tri is not None else TridiagResult(*got, band=band)


def _larfg(x):
    """Householder generator: (v, tau, beta) with ``(I - tau v v^H) x =
    beta e1``, ``v[0] = 1``, ``beta`` real (LAPACK larfg convention)."""
    x = np.asarray(x)
    m = x.shape[0]
    alpha = x[0]
    xnorm = np.linalg.norm(x[1:]) if m > 1 else 0.0
    if xnorm == 0.0 and np.imag(alpha) == 0.0:
        return np.zeros_like(x), x.dtype.type(0), np.real(alpha)
    r = np.hypot(np.abs(alpha), xnorm)
    beta = -np.copysign(r, np.real(alpha)) if np.real(alpha) != 0 else -r
    # LAPACK larfg gives H^H x = beta e1 for tau = (beta-alpha)/beta; we use
    # the H x = beta e1 convention, i.e. the conjugate tau.
    tau = np.conj((beta - alpha) / beta)
    v = x / (alpha - beta)
    v[0] = 1.0
    return v, x.dtype.type(tau), beta


def _apply_two_sided(s_mat, v, tau):
    """S <- H S H^H with H = I - tau v v^H, S Hermitian (dense window)."""
    u = s_mat @ v
    vhu = np.vdot(v, u)                      # real (S Hermitian)
    w = np.conj(tau) * u - (np.abs(tau) ** 2 * vhu / 2.0) * v
    return s_mat - np.outer(w, v.conj()) - np.outer(v, w.conj())


def band_to_tridiag_numpy(band: np.ndarray, b: int) -> TridiagResult:
    """Numpy bulge chase. ``band``: (b+1, n) lower 'sb' layout
    (``band[r, j] = A[j+r, j]``)."""
    n = band.shape[1]
    dtype = band.dtype
    cplx = np.issubdtype(dtype, np.complexfloating)
    # working storage with bulge headroom
    wb = np.zeros((2 * b + 1, n), dtype=dtype)
    wb[: b + 1] = band

    def get_win(j0, m):
        """Dense Hermitian window A[j0:j0+m, j0:j0+m] from band storage."""
        w = np.zeros((m, m), dtype=dtype)
        for r in range(min(m, 2 * b + 1)):
            dlen = m - r
            w[np.arange(r, m), np.arange(dlen)] = wb[r, j0: j0 + dlen]
        w = w + np.tril(w, -1).conj().T
        if cplx:
            np.fill_diagonal(w, np.real(np.diag(w)))
        return w

    def put_win(j0, w):
        m = w.shape[0]
        for r in range(min(m, 2 * b + 1)):
            dlen = m - r
            wb[r, j0: j0 + dlen] = w[np.arange(r, m), np.arange(dlen)]

    def _block_rows(i0, j0, mr, mc):
        """Banded-storage row indices of the dense block A[i0:i0+mr,
        j0:j0+mc]: column j0+c starts at storage row i0-(j0+c), so the
        block is an anti-diagonal window: one fancy-index gather/scatter
        instead of a per-column Python loop."""
        return (i0 - j0 - np.arange(mc))[None, :] + np.arange(mr)[:, None]

    def get_block(i0, j0, mr, mc):
        """Dense A[i0:i0+mr, j0:j0+mc] (strictly below-diag block)."""
        return wb[_block_rows(i0, j0, mr, mc),
                  j0 + np.arange(mc)[None, :]]

    def put_block(i0, j0, w):
        mr, mc = w.shape
        wb[_block_rows(i0, j0, mr, mc), j0 + np.arange(mc)[None, :]] = w

    n_sweeps = max(n - 2, 0)
    n_steps = ceil_div(max(n - 1, 1), b) if n > 1 else 0
    v_out = np.zeros((n_sweeps, n_steps, b), dtype=dtype)
    tau_out = np.zeros((n_sweeps, n_steps), dtype=dtype)

    for s in range(n_sweeps):
        l = min(b, n - 1 - s)
        if l < 1:
            continue
        x = wb[1: 1 + l, s].copy()
        v, tau, beta = _larfg(x)
        wb[1, s] = beta
        if l > 1:
            wb[2: 1 + l, s] = 0.0
        v_out[s, 0, :l] = v
        tau_out[s, 0] = tau
        j0, t = s + 1, 0
        while True:
            if tau != 0:
                sw = get_win(j0, l)
                sw = _apply_two_sided(sw, v, tau)
                put_win(j0, sw)
            l2 = min(b, n - (j0 + l))
            if l2 == 0:
                break
            bblk = get_block(j0 + l, j0, l2, l)
            if tau != 0:
                bblk = bblk - np.conj(tau) * np.outer(bblk @ v, v.conj())
            xcol = bblk[:, 0].copy()
            v2, tau2, beta2 = _larfg(xcol)
            bblk[:, 0] = 0.0
            bblk[0, 0] = beta2
            if tau2 != 0 and l > 1:
                rest = bblk[:, 1:]
                bblk[:, 1:] = rest - tau2 * np.outer(v2, v2.conj() @ rest)
            put_block(j0 + l, j0, bblk)
            t += 1
            v_out[s, t, :l2] = v2
            tau_out[s, t] = tau2
            j0, l, v, tau = j0 + l, l2, v2, tau2

    d = np.real(wb[0]).copy()
    e_raw = wb[1, : n - 1].copy()
    phase = np.ones(n, dtype=dtype)
    if cplx:
        for j in range(n - 1):
            mag = np.abs(e_raw[j])
            ph = e_raw[j] / mag if mag > 0 else 1.0
            # T = Phi T_real Phi^H with Phi[j+1] = Phi[j] * ph
            phase[j + 1] = phase[j] * ph
            e_raw[j] = mag
        e = np.real(e_raw)
    else:
        e = np.real(e_raw)
    return TridiagResult(d=d, e=e, v=v_out, tau=tau_out, phase=phase, band=b)


def band_to_tridiag(band: np.ndarray, b: int) -> TridiagResult:
    """The chase of the ``(b+1, n)`` lower 'sb' band (``band[r, j] =
    A[j+r, j]``) by the native chase, or by :func:`band_to_tridiag_numpy`
    (counted, strict raises) when its library cannot be built or loaded."""
    from ..health.registry import run_with_fallback

    def _native():
        from ..native import bindings

        return bindings.band_to_tridiag(band, b)

    return run_with_fallback("band_to_tridiag", _native,
                             lambda: band_to_tridiag_numpy(band, b), expected=RuntimeError)
