"""Hand-written Hopper kernel of the distributed Cholesky's predicated
trailing update, and its plain PyTorch version.

Counterpart of ``dlaf_tpu/tile_ops/pallas_kernels.py``.
:func:`masked_trailing_update` replaces ``masked_trailing_update``
(pallas_kernels.py:63, call :69): for every tile pair ``(r, c)`` of a
rank's trailing block, ``a[r, c] -= vr[r] @ vc[c]^T`` under ``mode[r, c]``:
0 skip, 1 the whole tile, 2 its lower triangle, 3 its upper triangle (the
uplo 'U' sweep passes transposed panel tiles). f32 accumulation, float32
or bfloat16 storage. The kernel (``csrc/update.cu``, built with ``nvcc``
for ``sm_90a`` at first use into ``_build/``, bound with ``ctypes``; see
:mod:`.cuda_build`) is bound by the f32 operations of the live pairs: a
one-block plan kernel lists the live 128 x 128 sub-tiles from the mode
table on the card, and a persistent kernel walks them with a cp.async
ring; its design is in the source's header.

The wrapper updates ``a`` IN PLACE (the reference returns a new block):
``a`` may be a strided view, a block of a rank's shard, whose tiles are
contiguous; nothing outside it is touched. Each panel stack goes to the
kernel as it is when it is contiguous or a transposed view of a contiguous
stack (``x.mT``, as the uplo 'U' sweep passes its row panel); only other
layouts are copied. It uses the plain version
(:func:`masked_trailing_update_plain`, out of place) only for a tensor on
the CPU; for a CUDA tensor it launches the kernels or raises. Each call
that launches adds one to ``LAUNCHES["masked_trailing_update"]``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..obs.trace import kernel_node
from . import cuda_build as cb

SUPPORTED = (torch.float32, torch.bfloat16)

#: Calls that launched the kernel (a plain integer).
LAUNCHES = {"masked_trailing_update": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dlaf_masked_update.argtypes = [I, P, L, L, P, P, P, P, I, I, I, I, P]
    lib.dlaf_masked_update.restype = I


#: ``csrc/update.cu``, built at first use into ``_build/``.
LIBRARY = cb.CudaLibrary("update", (), _bind)


def masked_trailing_update_plain(a: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor,
                                 mode: torch.Tensor) -> torch.Tensor:
    """The updated block, a new tensor: ``a`` (R, C, nb, nb), ``vr``
    (R, nb, nb), ``vc`` (C, nb, nb), ``mode`` (R, C) integer."""
    nb = a.shape[-1]
    acc = torch.matmul(vr.float()[:, None], vc.float()[None].mT)
    upd = a.float() - acc
    i = torch.arange(nb, device=a.device)
    m = mode.to(a.device)[:, :, None, None]
    keep = (m == 1) | ((m == 2) & (i[:, None] >= i[None, :])) \
        | ((m == 3) & (i[:, None] <= i[None, :]))
    return torch.where(keep, upd, a.float()).to(a.dtype)


def panel_layout(v: torch.Tensor) -> int | None:
    """How the kernel can read the panel stack ``v`` (n, nb, nb) in place:
    0 rows K-contiguous, 1 a transposed view of a contiguous stack, None
    neither (a copy is needed)."""
    n, nb, _ = v.shape
    if n > 1 and v.stride(0) != nb * nb:
        return None
    if v.stride(2) == 1 and v.stride(1) == nb:
        return 0
    if v.stride(1) == 1 and v.stride(2) == nb:
        return 1
    return None


@kernel_node(LAUNCHES, "masked_trailing_update")
@cb.on_device
def masked_trailing_update(a: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor,
                           mode: torch.Tensor) -> torch.Tensor:
    """``a[r, c] -= vr[r] @ vc[c]^T`` under ``mode[r, c]`` (0 skip / 1 full
    / 2 tile lower / 3 tile upper triangle), in place; returns ``a``.

    Replaces ``pallas_kernels.masked_trailing_update``. Bound by the f32
    operations of the live pairs; a plan kernel lists the live 128 x 128
    sub-tiles on the card and a persistent kernel walks them, so dead
    pairs and dead sub-tiles cost nothing."""
    if a.device.type == "cpu":
        return a.copy_(masked_trailing_update_plain(a, vr, vc, mode))
    R, C, nb, nb2 = a.shape
    if not a.is_cuda:
        raise ValueError(f"masked_trailing_update: expected a CUDA or CPU tensor, got {a.device}")
    if a.dtype not in SUPPORTED or vr.dtype != a.dtype or vc.dtype != a.dtype:
        raise TypeError(f"masked_trailing_update takes float32/bfloat16 a, vr, vc of one "
                        f"dtype, got {a.dtype}, {vr.dtype}, {vc.dtype}")
    if (nb != nb2 or tuple(vr.shape) != (R, nb, nb) or tuple(vc.shape) != (C, nb, nb)
            or tuple(mode.shape) != (R, C)):
        raise ValueError(f"masked_trailing_update: a {tuple(a.shape)}, vr {tuple(vr.shape)}, "
                         f"vc {tuple(vc.shape)}, mode {tuple(mode.shape)} do not match")
    if a.stride(3) != 1 or a.stride(2) != nb:
        raise ValueError("masked_trailing_update: the tiles of `a` must be contiguous")
    for t in (vr, vc, mode):
        if t.device != a.device:
            raise ValueError(f"masked_trailing_update: operands on {t.device} and {a.device}")
    lr, lc = panel_layout(vr), panel_layout(vc)
    if lr is None:
        vr, lr = vr.contiguous(), 0
    if lc is None:
        vc, lc = vc.contiguous(), 0
    mode = mode.to(torch.int32).contiguous()
    nsub = -(-nb // 128)
    plan = torch.empty(1 + R * C * nsub * nsub, dtype=torch.int32, device=a.device)
    cb.check(LIBRARY.load().dlaf_masked_update(
        0 if a.dtype == torch.float32 else 1, a.data_ptr(), a.stride(0), a.stride(1),
        vr.data_ptr(), vc.data_ptr(), mode.data_ptr(), plan.data_ptr(), R, C, nb, lr | lc << 1,
        cb.stream(a)), "masked_trailing_update")
    LAUNCHES["masked_trailing_update"] += 1
    return a


def supports_update(dtype: torch.dtype, device_type: str) -> bool:
    """Route gate (the reference's ``supports_pallas_update``): float32 and
    bfloat16 on ``cuda``. ``DLAF_FORCE_PALLAS_UPDATE=1``, the reference's
    test hook, opens it on the CPU too, where the plain version runs. That
    much is route policy (uncounted); ``health.inject.disable_pallas``
    then closes an open gate, the degradation counted at
    ``site="pallas_update"`` (``DLAF_STRICT`` raises)."""
    forced = os.environ.get(
        "DLAF_FORCE_PALLAS_UPDATE"  # dlaf: disable=lint-unregistered-knob(test hook forcing the update route's plain version on the CPU, the reference's; not a user-facing runtime knob)
    ) == "1"
    if not (dtype in SUPPORTED and (device_type == "cuda" or forced)):
        return False
    from ..health.registry import route_available

    return route_available("pallas", "pallas_update")
