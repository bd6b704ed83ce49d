"""Row and column permutations.

Port of ``dlaf_tpu/algorithms/permutations.py:39-47`` (reference
``permutations/general/api.h:22``, the CUDA gather kernel ``perms.cu``):
the local gather ``out[i] = in[perm[i]]`` along rows or columns, one
``index_select``. It is the primitive of the D&C merge's assembly. The
distributed ``permute`` of a :class:`..matrix.matrix.Matrix` over a grid
is not ported yet.
"""

from __future__ import annotations

import torch

from ..common.asserts import dlaf_assert


def permute_array(coord: str, perm, arr: torch.Tensor) -> torch.Tensor:
    """``out[i] = arr[perm[i]]`` along rows (``"Row"``) or columns
    (``"Col"``) of ``arr``; ``perm`` a host array or a tensor of indices."""
    dlaf_assert(coord in ("Row", "Col"), f"bad coord {coord!r}")
    idx = torch.as_tensor(perm, dtype=torch.int64).to(arr.device)
    return arr.index_select(0 if coord == "Row" else arr.dim() - 1, idx)
