"""Matrix container: tile storage, its distribution, and an optional grid.

Counterpart of ``dlaf_tpu/matrix/matrix.py``. A matrix on one rank (no
grid, or a 1x1 grid) holds the 4-D tile tensor of :mod:`.tiling` on one
device. A matrix on a grid of several ranks holds one shard ``(ltr, ltc,
mb, nb)`` per rank, in row-major rank order, each on its rank's device
(the block-cyclic local tiles of that rank, :func:`.tiling.split_shards`).
Unlike the JAX reference the storage is mutable: an algorithm that is given
``donate=True`` may overwrite it, and the caller must not use the matrix
afterwards.

On a multi-process grid (:func:`..comm.multihost.multihost_grid`) a
matrix holds only the shard of the rank its process drives: the other
entries of ``storage`` are None, and :meth:`Matrix.shards`,
:attr:`Matrix.device` and :meth:`Matrix.clone` see the local shard only.
:meth:`Matrix.from_element_fn` evaluates the element function on the
local tiles only, :meth:`Matrix.from_global` takes the local shard of a
global matrix every process holds (with ``root``: of one that only the
process of rank ``root`` holds, which sends each rank its shard),
:meth:`Matrix.to_global` all-gathers the shards, so every process gets
the global matrix, and :meth:`Matrix.gather_global` gathers them on one
process only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..comm import collectives as cc
from ..common.asserts import dlaf_assert
from ..common.index2d import GlobalElementSize, GridSize2D, RankIndex2D, TileElementSize
from ..types import torch_dtype
from . import tiling
from .distribution import Distribution


def _make_dist(size, block_size, grid, source_rank) -> Distribution:
    gs = grid.size if grid is not None else GridSize2D(1, 1)
    return Distribution(size, block_size, grid_size=gs, source_rank=source_rank)


class Matrix:
    def __init__(self, dist: Distribution, storage, grid=None):
        self.dist = dist
        self.grid = grid
        if grid is not None:
            dlaf_assert(grid.size == dist.grid_size,
                        f"grid {grid.size} != distribution grid {dist.grid_size}")
        Sr, Sc, ltr, ltc = tiling.storage_tile_grid(dist)
        mb, nb = dist.block_size.row, dist.block_size.col
        if self.distributed:
            P, Q = dist.grid_size.row, dist.grid_size.col
            dlaf_assert(len(storage) == P * Q, f"{len(storage)} shards for a {P}x{Q} grid")
            for i, s in enumerate(storage):
                local = grid.is_local(i // Q, i % Q)
                dlaf_assert((s is not None) == local,
                            f"shard {i}: {'missing' if local else 'held'} on a rank this "
                            f"process {'drives' if local else 'does not drive'}")
                if s is not None:
                    dlaf_assert(tuple(s.shape) == (ltr, ltc, mb, nb),
                                f"shard {i} shape {tuple(s.shape)} != {(ltr, ltc, mb, nb)}")
            storage = list(storage)
        else:
            dlaf_assert(tuple(storage.shape) == (Sr, Sc, mb, nb),
                        f"storage shape {tuple(storage.shape)} != {(Sr, Sc, mb, nb)}")
        self.storage = storage

    @classmethod
    def from_global(cls, a, block_size: TileElementSize, grid=None, *,
                    source_rank: RankIndex2D = RankIndex2D(0, 0), device="cuda",
                    root: Optional[RankIndex2D] = None, size: Optional[GlobalElementSize] = None,
                    dtype=None) -> "Matrix":
        """Tile a global matrix (numpy array or tensor): onto ``device``
        without a grid, else block-cyclically onto the grid's ranks (on a
        multi-process grid: the local rank's shard only).

        ``root``: the global matrix exists on the process that drives rank
        ``root`` only (the other processes pass ``a=None``, and every
        process passes ``size`` and ``dtype``); that process cuts the
        shards and sends each rank its own (:func:`..comm.collectives.
        scatter`), so no other process holds the whole matrix. Under the
        single controller it is the plain form."""
        if grid is not None:
            device = grid.device(*grid.local_ranks[0])
        if root is not None and grid is not None and grid.multi_process:
            dlaf_assert(size is not None and dtype is not None,
                        "from_global(root=...): every process passes size and dtype")
            dtype = torch_dtype(dtype)
            dist = _make_dist(size, block_size, grid, source_rank)
            P, Q = grid.size.row, grid.size.col
            parts = None
            if grid.is_local(root.row, root.col):
                t = torch.as_tensor(a, device=device)
                dlaf_assert(tuple(t.shape) == (size.row, size.col) and t.dtype == dtype,
                            f"from_global(root=...): a {tuple(t.shape)} {t.dtype} for "
                            f"{size} {dtype}")
                flat = tiling.split_shards(tiling.global_to_tiles(t, dist), dist,
                                           [device] * (P * Q))
                parts = [flat[r * Q:(r + 1) * Q] for r in range(P)]
            _, _, ltr, ltc = tiling.storage_tile_grid(dist)
            shape = (ltr, ltc, block_size.row, block_size.col)
            like = cc.per_rank(P, Q, lambda r, c: torch.empty(shape, dtype=dtype, device=device))
            got = cc.scatter(parts, root.row, root.col, like)
            return cls(dist, [v for row in got for v in row], grid)
        t = torch.as_tensor(a, device=device if grid is None or grid.num_devices == 1
                            else None)
        dist = _make_dist(GlobalElementSize(t.shape[0], t.shape[1]), block_size, grid,
                          source_rank)
        tiles = tiling.global_to_tiles(t, dist)
        if grid is None or grid.num_devices == 1:
            return cls(dist, tiles, grid)
        return cls(dist, tiling.split_shards(tiles, dist, grid.devices), grid)

    @classmethod
    def from_element_fn(cls, fn: Callable, size: GlobalElementSize,
                        block_size: TileElementSize, grid=None, *, dtype=np.float64,
                        source_rank: RankIndex2D = RankIndex2D(0, 0),
                        device="cuda") -> "Matrix":
        """Build from an element function ``fn(i, j)`` that broadcasts over
        float64 index tensors, evaluated in ``dtype`` on the device of
        each rank, for that rank's local tiles only (on a multi-process
        grid: for the local rank only)."""
        tdt = torch_dtype(dtype)
        dist = _make_dist(size, block_size, grid, source_rank)
        if grid is None or grid.num_devices == 1:
            dev = grid.device(0, 0) if grid is not None else device
            i = torch.arange(size.row, device=dev, dtype=torch.float64)
            j = torch.arange(size.col, device=dev, dtype=torch.float64)
            return cls(dist, tiling.global_to_tiles(fn(i[:, None], j[None, :]).to(tdt), dist),
                       grid)
        _, _, ltr, ltc = tiling.storage_tile_grid(dist)
        mb, nb = block_size.row, block_size.col
        shards = [None] * (grid.size.row * grid.size.col)
        for r, c in grid.local_ranks:
            i, j, mi, mj = tiling.shard_element_indices(dist, r, c, grid.device(r, c))
            vals = fn(i[:, None], j[None, :]).to(tdt)
            vals = torch.where(mi[:, None] & mj[None, :], vals, torch.zeros((), dtype=tdt,
                                                                            device=i.device))
            shards[r * grid.size.col + c] = (vals.reshape(ltr, mb, ltc, nb).permute(0, 2, 1, 3)
                                             .contiguous())
        return cls(dist, shards, grid)

    @property
    def distributed(self) -> bool:
        """Does the matrix live on a grid of more than one rank?"""
        return self.grid is not None and self.grid.num_devices > 1

    def shards(self) -> list:
        """Per-rank tile storage of the ranks this process drives, row-major
        rank order (one entry on one rank, or on a multi-process grid)."""
        if not self.distributed:
            return [self.storage]
        return [s for s in self.storage if s is not None]

    def nested(self) -> list:
        """The storage of a distributed matrix as a nested per-rank list
        ``[r][c]`` (None at the ranks other processes drive)."""
        Q = self.dist.grid_size.col
        return [self.storage[r * Q:(r + 1) * Q] for r in range(self.dist.grid_size.row)]

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
        return self.shards()[0].dtype

    @property
    def device(self) -> torch.device:
        """The device of rank (0, 0) (on a multi-process grid: of the local
        rank)."""
        return self.shards()[0].device

    def to_global(self) -> torch.Tensor:
        """The global matrix as a new tensor on :attr:`device`. On a
        multi-process grid every process calls it and gets the global
        matrix: the shards are all-gathered along both grid axes."""
        if not self.distributed:
            return tiling.tiles_to_global(self.storage, self.dist)
        shards = [s for row in cc.gather_grid(self.nested()) for s in row]
        return tiling.tiles_to_global(tiling.join_shards(shards, self.dist, self.device),
                                      self.dist)

    def gather_global(self, root: RankIndex2D = RankIndex2D(0, 0)):
        """The global matrix as a new tensor on the process that drives
        rank ``root`` (on its device), None on the other processes: the
        shards are gathered there only. Under the single controller (and
        without a grid) it is :meth:`to_global`, on :attr:`device`."""
        if not (self.distributed and self.grid.multi_process):
            return self.to_global()
        got = cc.gather(self.nested(), root.row, root.col)
        if got is None:
            return None
        dev = self.grid.device(root.row, root.col)
        return tiling.tiles_to_global(tiling.join_shards([s for row in got for s in row],
                                                         self.dist, dev), self.dist)

    def to_numpy(self) -> np.ndarray:
        return self.to_global().cpu().numpy()  # dlaf: disable=lint-host-sync(the conversion to numpy the caller asks for)

    def with_storage(self, storage) -> "Matrix":
        """New Matrix sharing this layout and grid."""
        return Matrix(self.dist, storage, self.grid)

    def clone(self) -> "Matrix":
        """A Matrix over copies of this one's tensors."""
        if self.distributed:
            return self.with_storage([s if s is None else s.clone() for s in self.storage])
        return self.with_storage(self.storage.clone())

    def __str__(self) -> str:
        g = f", grid={self.grid}" if self.grid is not None else ""
        return (f"Matrix(size={self.size}, block={self.block_size}, "
                f"dtype={self.dtype}, device={self.device}{g})")
