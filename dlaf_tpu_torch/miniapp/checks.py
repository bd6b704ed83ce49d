"""Precision of the miniapps' residual checks.

Port of ``dlaf_tpu/miniapp/checks.py:40-78``. The reference widens the
float64 eps on its TPU, whose float64 is emulated by float pairs; on a
CUDA card (and the CPU) float64 is native, so :func:`effective_eps` is the
dtype's own eps and its label is empty.
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
