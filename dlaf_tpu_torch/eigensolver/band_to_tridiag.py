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
own copy, built at first use). A failed build raises: the reference's
numpy twin and its fallback to it through the health registry come with
that registry.

Complex matrices: the chase leaves a Hermitian tridiagonal with complex
off-diagonals; it is phase-normalized to a REAL symmetric tridiagonal
(LAPACK ``hbtrd``'s convention), with the unit phases returned so that the
back-transform can restore them (``T_complex = Phi T_real Phi^H``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


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


def band_to_tridiag(band: np.ndarray, b: int) -> TridiagResult:
    """The chase of the ``(b+1, n)`` lower 'sb' band (``band[r, j] =
    A[j+r, j]``) by the native chase; raises when its library cannot be
    built or loaded."""
    from ..native import bindings

    return bindings.band_to_tridiag(band, b)
