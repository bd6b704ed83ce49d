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
rows each rotation reads and writes. Its design is in the source's
header.

For each rotation ``(i, j, c, s)`` in order, on the rows of the float64
matrix ``u`` IN PLACE: ``u[i], u[j] <- c u[i] - s u[j], s u[i] + c u[j]``.
The kernel rounds each product and sum separately, so it is bitwise the
plain version (:func:`givens_undo_plain`, the loop), which the wrapper
takes only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. Each launch adds one to ``LAUNCHES["givens_undo"]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build as cb

#: Calls that launched the kernel (a plain integer).
LAUNCHES = {"givens_undo": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.dlaf_givens_undo.argtypes = [P, L, L, P, P, L, P]
    lib.dlaf_givens_undo.restype = ctypes.c_int


#: ``csrc/givens.cu``, built at first use into ``_build/``.
LIBRARY = cb.CudaLibrary("givens", (), _bind)


def givens_undo_plain(u: torch.Tensor, giv) -> torch.Tensor:
    """The rotations ``giv`` ``(g, 4)`` = ``(i, j, c, s)`` (host data)
    applied in order to the rows of ``u``, in place; returns ``u``."""
    for i, j, c, s in torch.as_tensor(giv, dtype=torch.float64).tolist():
        i, j = int(i), int(j)
        ri, rj = u[i].clone(), u[j].clone()
        u[i] = c * ri - s * rj
        u[j] = s * ri + c * rj
    return u


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
    giv = torch.as_tensor(giv, dtype=torch.float64)
    if giv.device.type != "cpu" or giv.dim() != 2 or giv.shape[1] != 4:
        raise ValueError(f"givens_undo: rotations of shape {tuple(giv.shape)} on "
                         f"{giv.device}, expected (g, 4) host data")
    g = giv.shape[0]
    if g == 0:
        return u
    ij = giv[:, :2].to(torch.int64)
    if bool(((ij < 0) | (ij >= u.shape[0])).any()):
        raise ValueError("givens_undo: a rotation's row lies outside u")
    ij = ij.contiguous().to(u.device)
    cs = giv[:, 2:].contiguous().to(u.device)
    cb.check(LIBRARY.load().dlaf_givens_undo(u.data_ptr(), u.stride(0), u.shape[1],
                                              ij.data_ptr(), cs.data_ptr(), g, cb.stream(u)),
             "givens_undo")
    LAUNCHES["givens_undo"] += 1
    return u
