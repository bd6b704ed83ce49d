"""Matrix dumps for debugging.

Port of ``dlaf_tpu/matrix/printing.py`` (reference ``matrix/print_numpy.h``,
``print_csv.h``): a numpy-expression or CSV rendering of a
:class:`.matrix.Matrix`, whose shards are gathered to the host first.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from .matrix import Matrix


def print_numpy(mat: Matrix, name: str = "a", file=None) -> str:
    """Emit ``name = np.array([...])`` (reference format::numpy)."""
    a = mat.to_numpy()
    buf = io.StringIO()
    buf.write(f"{name} = np.array(")
    buf.write(np.array2string(a, separator=", ", threshold=np.inf, floatmode="unique"))
    buf.write(f", dtype=np.{a.dtype})\n")
    s = buf.getvalue()
    print(s, file=file or sys.stdout, end="")
    return s


def print_csv(mat: Matrix, file=None) -> str:
    """Comma-separated rows (reference format::csv)."""
    a = mat.to_numpy()
    buf = io.StringIO()
    for row in np.atleast_2d(a):
        buf.write(",".join(repr(x) for x in row.tolist()))
        buf.write("\n")
    s = buf.getvalue()
    print(s, file=file or sys.stdout, end="")
    return s
