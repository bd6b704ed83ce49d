"""Carry the JAX package's matrix state into the port and back.

The JAX reference keeps a matrix as a 4-D tile storage array
(``dlaf_tpu/matrix/tiling.py``); this port keeps the same layout. These two
functions move that storage, as a numpy array, into a port ``Matrix`` and
out again, so both packages can factor exactly the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from .distribution import Distribution
from .matrix import Matrix


def from_jax_storage(np_tiles: np.ndarray, dist: Distribution, *,
                     device="cuda") -> Matrix:
    """Port Matrix over a copy of the reference's tile storage."""
    return Matrix(dist, torch.tensor(np.ascontiguousarray(np_tiles), device=device))


def to_jax_storage(mat: Matrix) -> np.ndarray:
    """The Matrix's tile storage as a numpy array in the reference layout."""
    return mat.storage.detach().cpu().numpy()
