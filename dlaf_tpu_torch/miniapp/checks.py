"""Precision and reporting of the miniapps' residual checks.

Port of ``dlaf_tpu/miniapp/checks.py:40-78``. The reference widens the
float64 eps on its TPU, whose float64 is emulated by float pairs; on a
CUDA card (and the CPU) float64 is native, so :func:`effective_eps` is the
dtype's own eps and its label is empty.

:func:`report` is the ``check:`` line of every miniapp: the estimate goes
through :func:`..obs.accuracy.emit` (an ``accuracy`` record with
``check: true`` in its attrs), and the line keeps its format,
``check: PASSED|FAILED residual=<value> tol=<c n eps>``.
"""

from __future__ import annotations

import numpy as np
import torch


def effective_eps(dtype) -> tuple[float, str]:
    """``(eps, label)`` for ``c n eps`` tolerances: the eps of ``dtype``'s
    real type (numpy or torch dtype), and ``""`` (nothing widened)."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    real = np.dtype(dtype).type(0).real.dtype
    return float(np.finfo(real).eps), ""


def report(site: str, metric: str, value: float, *, n: int, nb: int, c: float, dtype,
           of=None, attrs=None, printer: bool = True, extra: str = "") -> bool:
    """Emit a checked estimate's ``accuracy`` record and (``printer``) print
    its ``check:`` line (``extra`` after the residual); returns whether it
    passed: finite and below ``c n eps``."""
    return report_result(site, metric, value, n=n, nb=nb, c=c, dtype=dtype, of=of,
                         attrs=attrs, printer=printer, extra=extra).passed


def report_result(site: str, metric: str, value: float, *, n: int, nb: int, c: float, dtype,
                  of=None, attrs=None, printer: bool = True, extra: str = ""):
    """:func:`report`, returning the :class:`..obs.accuracy.AccuracyResult`
    (what the Cholesky miniapp feeds the autotuner)."""
    from ..obs import accuracy

    res = accuracy.emit(site, metric, value, n=n, nb=nb, c=c, dtype=dtype, of=of,
                        attrs=dict(attrs or {}, check=True))
    if printer:
        print(f"check: {'PASSED' if res.passed else 'FAILED'} residual={float(value):.3e}"
              f"{extra} tol={res.tol:.3e}{res.eps_label}", flush=True)
    return res
