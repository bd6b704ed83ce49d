"""Blocking host tier: what tests and result checks use.

Counterpart of ``dlaf_tpu/comm/sync.py`` (reference ``communication/sync``).
The single controller addresses every rank's shard, so the blocking verbs
are device-to-host moves and host folds, never algorithm hot paths. In the
multi-process form (:mod:`.multihost`) the shards of other processes'
ranks are all-gathered first, so every process gets what the single
controller would, and :func:`barrier` also waits for every process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..common.sync import hard_fence
from . import collectives as cc

__all__ = ["gather", "gather_shards", "all_reduce", "reduce", "barrier"]


def gather(mat) -> np.ndarray:
    """The global matrix of a (possibly distributed) ``Matrix`` on the
    host."""
    return mat.to_global().cpu().numpy()


def gather_shards(x) -> list:
    """Per-rank host copies, in row-major rank order: of a ``Matrix``'s
    shards, of a nested per-rank list, or of one tensor. In the
    multi-process form a Matrix's or a nested list's values are
    all-gathered first, so every process gets every rank's."""
    if hasattr(x, "shards"):
        x = x.nested() if x.distributed else x.shards()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], (list, tuple)):
        x = [v for row in cc.gather_grid(x) for v in row]
    if isinstance(x, torch.Tensor):
        x = [x]
    return [v.detach().cpu().numpy() for v in x]


def all_reduce(values, op: str = "sum"):
    """Host fold of per-rank values (reference ``sync::allReduceInPlace``):
    the values of every rank, as :func:`gather_shards` returns them."""
    ops = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}
    if op not in ops:
        raise ValueError(f"unsupported reduce op {op!r}")
    return ops[op](np.stack([np.asarray(v) for v in values]), axis=0)


def reduce(values, root: int = 0, op: str = "sum"):
    """Host fold "to ``root``": the host plays every rank, so the result
    does not depend on ``root`` (kept for the reference's signature)."""
    del root
    return all_reduce(values, op)


def barrier(*xs) -> None:
    """Block until the work producing ``xs`` (tensors or Matrices, every
    local shard) has run: :func:`..common.sync.hard_fence` over them, then,
    in a world of several processes, until every process has reached the
    barrier (reference ``MPI_Barrier`` in the miniapp timing)."""
    hard_fence(*[t for x in xs for t in (x.shards() if hasattr(x, "shards") else [x])])
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
