"""Hand-written Hopper kernel of the D&C merge's Givens undo, and its
plain PyTorch version.

Not a port of a Pallas kernel: the JAX package applies the merge's
deflation rotations with a ``lax.scan`` on its device
(``dlaf_tpu/eigensolver/tridiag_solver.py:305-314``). In eager PyTorch that
sequence is a loop of several launches a rotation, so
:func:`givens_undo` applies the whole list in one launch of
``csrc/givens.cu`` (built with ``nvcc`` for ``sm_90a`` at first use into
``_build/``, bound with ``ctypes``; see :mod:`.cuda_build`): one thread a
column, looping over the rotations in order, bound by the bytes of the two
rows each rotation reads and writes once ``DEPTH`` rotations' rows are
loaded ahead. :func:`schedule` works out on the host where each rotation's
rows come from (loaded ahead, the previous rotation's registers, or
memory when it is applied) and which new rows are stored. Its design is in
the source's header.

For each rotation ``(i, j, c, s)`` in order, on the rows of the float64
matrix ``u`` IN PLACE: ``u[i], u[j] <- c u[i] - s u[j], s u[i] + c u[j]``.
The kernel rounds each product and sum separately, so it is bitwise the
plain version (:func:`givens_undo_plain`, the loop), which the wrapper
takes only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. Each launch adds one to ``LAUNCHES["givens_undo"]``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..obs.trace import kernel_node
from . import cuda_build as cb

#: Calls that launched the kernel (a plain integer).
LAUNCHES = {"givens_undo": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: Rotations whose rows the kernel loads ahead of the one it applies
#: (``kDepth`` in ``csrc/givens.cu``).
DEPTH = 16

#: Where a rotation's row comes from in the kernel (:func:`schedule`):
#: loaded ``DEPTH`` rotations ahead, the previous rotation's new row i or
#: j (a register), or memory when the rotation is applied.
PREFETCH, FROM_I, FROM_J, RELOAD = 0, 1, 2, 3
#: Flags: store the new row i / j (the next rotation does not take it).
STORE_I, STORE_J = 16, 32


def _bind(lib) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dlaf_givens_undo.argtypes = [P, L, L, P, I, I, P]
    lib.dlaf_givens_undo.restype = ctypes.c_int


#: ``csrc/givens.cu``, built at first use into ``_build/``.
LIBRARY = cb.CudaLibrary("givens", (), _bind)


def givens_undo_plain(u: torch.Tensor, giv) -> torch.Tensor:
    """The rotations ``giv`` ``(g, 4)`` = ``(i, j, c, s)`` (host data)
    applied in order to the rows of ``u``, in place; returns ``u``."""
    for i, j, c, s in torch.as_tensor(giv, dtype=torch.float64).tolist():  # dlaf: disable=lint-host-sync(the rotations are host data)
        i, j = int(i), int(j)
        ri, rj = u[i].clone(), u[j].clone()
        u[i] = c * ri - s * rj
        u[j] = s * ri + c * rj
    return u


def dependencies(ij) -> np.ndarray:
    """``(g, 2)`` int64: for rotation t and each of its rows ``ij[t, 0]``,
    ``ij[t, 1]``, the last earlier rotation that touches that row (as its
    i or its j), or -1."""
    rows = np.asarray(ij, dtype=np.int64).reshape(-1)   # event 2t: row i_t, 2t + 1: row j_t
    n = rows.size
    # events by row, then by event, from one sort of distinct keys
    row, ev = np.divmod(np.sort(rows * n + np.arange(n)), n)
    dep = np.full(n, -1, dtype=np.int64)
    same = row[1:] == row[:-1]
    dep[ev[1:][same]] = ev[:-1][same] // 2
    return dep.reshape(-1, 2)


def schedule(giv, depth: int = DEPTH) -> np.ndarray:
    """The kernel's schedule of the rotations ``giv`` ``(g, 4)``: ``(g, 8)``
    int32 records, ``(i, j, flags, 0)`` then ``(c, s)`` as float64 in bytes
    16-31 (``rec.view(np.float64)[:, 2:]``). Row r of rotation t, whose last
    earlier writer is p (:func:`dependencies`), is ``FROM_I``/``FROM_J``
    when p = t - 1 (the previous rotation's new row i or j), ``PREFETCH``
    when there is none or p <= t - ``depth`` (the load ahead, issued once
    rotation t - ``depth`` is stored, sees it), else ``RELOAD``; a new row
    is stored unless the next rotation touches it. A rotation of a row with
    itself is refused."""
    giv = np.asarray(giv, dtype=np.float64).reshape(-1, 4)
    ij = giv[:, :2].astype(np.int64)
    i, j = ij[:, 0], ij[:, 1]
    if (i == j).any():
        raise ValueError("givens_undo: a rotation of a row with itself")
    g = ij.shape[0]
    t = np.arange(g)[:, None]
    dep = dependencies(ij)
    src = np.where((dep < 0) | (dep <= t - depth), PREFETCH, RELOAD)
    if g > 1:
        prev = dep == t - 1                # dep >= 0 there, since t >= 1
        prev[0] = False
        from_i = np.empty((g, 2), dtype=bool)
        from_i[0] = False
        from_i[1:] = ij[1:] == i[:-1, None]
        src = np.where(prev, np.where(from_i, FROM_I, FROM_J), src)
    flags = src[:, 0] | src[:, 1] << 2 | STORE_I | STORE_J
    # no store of a new row that the next rotation takes from its register
    flags[:-1] &= ~np.where((i[:-1] == i[1:]) | (i[:-1] == j[1:]), STORE_I, 0)
    flags[:-1] &= ~np.where((j[:-1] == i[1:]) | (j[:-1] == j[1:]), STORE_J, 0)
    rec = np.zeros((g, 8), dtype=np.int32)
    rec[:, :2] = ij
    rec[:, 2] = flags
    rec.view(np.float64)[:, 2:] = giv[:, 2:]
    return rec


@kernel_node(LAUNCHES, "givens_undo")
@cb.on_device
def givens_undo(u: torch.Tensor, giv) -> torch.Tensor:
    """:func:`givens_undo_plain` in one kernel launch: ``u`` ``(n, w)``
    float64 with contiguous rows, ``giv`` ``(g, 4)`` host data (row
    indices, cosine, sine; checked on the host, then copied to the card),
    in place; returns ``u``."""
    if u.device.type == "cpu":
        return givens_undo_plain(u, giv)
    if not u.is_cuda:
        raise ValueError(f"givens_undo: expected a CUDA or CPU tensor, got {u.device}")
    if u.dtype != torch.float64 or u.dim() != 2 or u.stride(1) != 1:
        raise TypeError(f"givens_undo takes a float64 (n, w) tensor with contiguous rows, got "
                        f"{u.dtype} {tuple(u.shape)} strides {u.stride()}")
    if isinstance(giv, torch.Tensor) and giv.device.type != "cpu":
        raise ValueError(f"givens_undo: rotations on {giv.device}, expected host data")
    giv = np.asarray(giv, dtype=np.float64)
    if giv.ndim != 2 or giv.shape[1] != 4:
        raise ValueError(f"givens_undo: rotations of shape {giv.shape}, expected (g, 4)")
    g = giv.shape[0]
    if g == 0:
        return u
    rows = giv[:, :2]
    if ((rows < 0) | (rows >= u.shape[0])).any() or u.shape[0] >= 2 ** 31:
        raise ValueError("givens_undo: a rotation's row lies outside u")
    rec = torch.from_numpy(schedule(giv)).to(u.device)
    cb.check(LIBRARY.load().dlaf_givens_undo(u.data_ptr(), u.stride(0), u.shape[1],
                                              rec.data_ptr(), g, DEPTH, cb.stream(u)),
             "givens_undo")
    LAUNCHES["givens_undo"] += 1
    return u
