"""Carry the JAX package's matrix state into the port and back.

The JAX reference keeps a matrix as one 4-D tile storage array
``(P*ltr, Q*ltc, mb, nb)`` in its rank-major cyclic-permuted order
(``dlaf_tpu/matrix/tiling.py``); the port keeps the same global layout, on
one device or split into per-rank shards on a grid. These two functions
move that storage, as a numpy array, into a port ``Matrix`` and out again,
so both packages can factor exactly the same matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tiling
from .distribution import Distribution
from .matrix import Matrix


def from_jax_storage(np_tiles: np.ndarray, dist: Distribution, *, grid=None,
                     device="cuda") -> Matrix:
    """Port Matrix over a copy of the reference's tile storage: on
    ``device`` without a grid, else split into the grid's per-rank shards
    (``dist`` must carry the grid's size and the source rank)."""
    t = torch.tensor(np.ascontiguousarray(np_tiles),
                     device=grid.device(0, 0) if grid is not None else device)
    if grid is None or grid.num_devices == 1:
        return Matrix(dist, t, grid)
    return Matrix(dist, tiling.split_shards(t, dist, grid.devices), grid)


def to_jax_storage(mat: Matrix) -> np.ndarray:
    """The Matrix's tile storage as a numpy array in the reference layout
    (shards joined)."""
    t = tiling.join_shards(mat.storage, mat.dist, "cpu") if mat.distributed else mat.storage
    return t.detach().cpu().numpy()
