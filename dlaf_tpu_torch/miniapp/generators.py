"""Analytic matrix generators for the miniapps and tests.

A copy of ``dlaf_tpu/miniapp/generators.py`` (``hpd_element_fn`` and the
dense host ``random_hermitian``), and a Hermitian companion for HEGST's
A: closed-form, deterministic element functions, so inputs at N=16384
need no O(n^3) host set-up. They work on numpy arrays and on torch
tensors alike.
"""

from __future__ import annotations

import numpy as np

from ..types import is_complex


def hpd_element_fn(n: int, dtype):
    """Hermitian positive-definite element function.

    ``a(i,j) = 1/(1+|i-j|) + n·[i==j]`` (+ a small skew-Hermitian imaginary
    part for complex types): strictly diagonally dominant, hence HPD, with
    condition number O(n).
    """
    def fn(i, j):
        d = abs(i - j)
        base = 1.0 / (1.0 + d) + n * (i == j)
        if is_complex(dtype):
            sign = 1.0 * (j > i) - 1.0 * (j < i)
            return base + 1j * (sign / (1.0 + d) / 2.0)
        return base
    return fn


def herm_element_fn(n: int, dtype):
    """Hermitian (indefinite) element function, not a multiple of
    :func:`hpd_element_fn`: ``a(i,j) = (i+j+1) / (n (1+|i-j|))`` (+ the
    same small skew-Hermitian imaginary part for complex types)."""
    def fn(i, j):
        d = abs(i - j)
        base = (i + j + 1.0) / (n * (1.0 + d))
        if is_complex(dtype):
            sign = 1.0 * (j > i) - 1.0 * (j < i)
            return base + 1j * (sign / (1.0 + d) / 2.0)
        return base
    return fn


def random_hermitian(n: int, dtype, seed: int = 0, diag_boost: float | None = None):
    """A dense random Hermitian host matrix (numpy), shifted by
    ``diag_boost`` times the identity when given; O(n^2)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if is_complex(dtype):
        x = x + 1j * rng.standard_normal((n, n))
    a = (x + x.conj().T) / 2
    if diag_boost:
        a = a + diag_boost * np.eye(n)
    return a.astype(dtype)
