"""Matrix container: one tile-storage tensor plus its distribution.

Counterpart of ``dlaf_tpu/matrix/matrix.py`` on the 1x1 grid. The storage
is the 4-D tile tensor of :mod:`.tiling` on one device. Unlike the JAX
reference the storage is a mutable tensor: an algorithm that is given
``donate=True`` may overwrite it, and the caller must not use the matrix
afterwards.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..common.asserts import dlaf_assert
from ..common.index2d import GlobalElementSize, TileElementSize
from ..types import torch_dtype
from . import tiling
from .distribution import Distribution


class Matrix:
    def __init__(self, dist: Distribution, storage: torch.Tensor):
        Sr, Sc, _, _ = tiling.storage_tile_grid(dist)
        expect = (Sr, Sc, dist.block_size.row, dist.block_size.col)
        dlaf_assert(tuple(storage.shape) == expect,
                    f"storage shape {tuple(storage.shape)} != {expect}")
        self.dist = dist
        self.storage = storage

    @classmethod
    def from_global(cls, a, block_size: TileElementSize, *,
                    device="cuda") -> "Matrix":
        """Tile a global matrix (numpy array or tensor) onto ``device``."""
        t = torch.as_tensor(a, device=device)
        dist = Distribution(GlobalElementSize(t.shape[0], t.shape[1]), block_size)
        return cls(dist, tiling.global_to_tiles(t, dist))

    @classmethod
    def from_element_fn(cls, fn: Callable, size: GlobalElementSize,
                        block_size: TileElementSize, *, dtype=np.float64,
                        device="cuda") -> "Matrix":
        """Build from an element function ``fn(i, j)`` that broadcasts over
        index tensors; evaluated on ``device`` in ``dtype``."""
        i = torch.arange(size.row, device=device, dtype=torch.float64)
        j = torch.arange(size.col, device=device, dtype=torch.float64)
        a = fn(i[:, None], j[None, :]).to(torch_dtype(dtype))
        dist = Distribution(size, block_size)
        return cls(dist, tiling.global_to_tiles(a, dist))

    @property
    def size(self) -> GlobalElementSize:
        return self.dist.size

    @property
    def block_size(self) -> TileElementSize:
        return self.dist.block_size

    @property
    def nr_tiles(self):
        return self.dist.nr_tiles

    @property
    def dtype(self) -> torch.dtype:
        return self.storage.dtype

    @property
    def device(self) -> torch.device:
        return self.storage.device

    def to_global(self) -> torch.Tensor:
        """The global matrix as a new tensor on the storage's device."""
        return tiling.tiles_to_global(self.storage, self.dist)

    def to_numpy(self) -> np.ndarray:
        return self.to_global().cpu().numpy()

    def with_storage(self, storage: torch.Tensor) -> "Matrix":
        """New Matrix sharing this layout."""
        return Matrix(self.dist, storage)

    def __str__(self) -> str:
        return (f"Matrix(size={self.size}, block={self.block_size}, "
                f"dtype={self.dtype}, device={self.device})")
