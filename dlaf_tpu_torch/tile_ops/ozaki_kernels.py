"""Hand-written Hopper kernels of the Ozaki slice products, and their plain
PyTorch versions.

Counterpart of ``dlaf_tpu/tile_ops/pallas_ozaki.py``. Three wrappers over
one CUDA kernel template in ``csrc/ozaki.cu`` (built with ``nvcc`` for
``sm_90a`` at first use into ``_build/``, bound with ``ctypes``; see
:mod:`.cuda_build`):

:func:`ozaki_product`
    Replaces ``pallas_ozaki.fused_slice_product`` (pallas_ozaki.py:112,
    call :133): for stacked int8 slices ``ia`` (s, M, K) and ``ib``
    (s, K, N), ``hi + lo ~= sum_{d<s} 2^-7(d+2) sum_{t<=d} IA_t @ IB_{d-t}``
    as two float32 planes.
:func:`ozaki_syrk`
    Replaces ``pallas_ozaki.fused_slice_syrk`` (:249, call :269): the same
    fold for ``IA @ IA^T``, valid on the 256-row blocks on and below the
    block diagonal, zero above (the caller mirrors).
:func:`ozaki_masked_product`
    Replaces ``pallas_ozaki.masked_slice_product`` (:185, call :208): the
    fold per tile pair ``(r, c)`` of ``ia`` (s, R, bm, K) and ``ib``
    (s, C, bn, K), both contracting their last axis, predicated on a mode
    table: pairs with mode 0 skip their products and come out zero. The
    distributed Cholesky's exact-flop float64 trailing update.

Each output element is the double-f32 fold of exact integer group sums in
the order of the reference's ``_fold_body``, so kernel, plain version and
the Pallas kernels agree bit for bit. Bound on the card by the int8
tensor-core operations, ``s(s+1)/2 * 2 M N K``, which only ``wgmma``
reaches: the kernel runs the reference's shift-outer loop (one int32
accumulator per output element, folded after each shift), with
``wgmma`` on 128 x 128 tiles fed from a TMA-loaded ring of shared-memory
stages, one persistent block per SM walking the live tiles first. The
design is in the source's header. ``K`` is zero-padded to a multiple of
32 here (exact), and ``ib`` is handed to the kernel transposed, so both
operands are K-contiguous rows, 16-byte aligned as TMA needs.

Each wrapper uses its plain version (``ozaki_product_plain``,
``ozaki_syrk_plain``) only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..obs.trace import kernel_node
from . import cuda_build as cb

SLICE_BITS = 7

#: Deepest contraction the kernels take (the reference's ``K_MAX``).
K_MAX = 1024

#: Block edge of the syrk's output contract (the reference's default
#: ``block``): blocks strictly above the block diagonal are zero.
SYRK_BLOCK = 256

#: Most slices the kernel is instantiated for (``f64_gemm_slices`` <= 9).
MAX_SLICES = 9

#: Largest tile edge (bm, bn and K) the masked pair product takes (the
#: reference's ``MASKED_MB_MAX``).
MASKED_MB_MAX = 256

#: Calls that launched each kernel (plain integers).
LAUNCHES = {"ozaki_product": 0, "ozaki_syrk": 0, "ozaki_masked_product": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.dlaf_oz_product.argtypes = [I, P, P, I, I, I, P, P, P]
    lib.dlaf_oz_syrk.argtypes = [I, P, I, I, I, P, P, P]
    lib.dlaf_oz_masked.argtypes = [I, P, P, P, I, I, I, I, I, P, P, P]
    for fn in (lib.dlaf_oz_product, lib.dlaf_oz_syrk, lib.dlaf_oz_masked):
        fn.restype = I


#: ``csrc/ozaki.cu``, built at first use into ``_build/``. No FMA
#: contraction: the fold's bits must not depend on the compiler.
LIBRARY = cb.CudaLibrary("ozaki", ("-fmad=false",), _bind)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def group_sums(ia: torch.Tensor, ib_rows: torch.Tensor):
    """Exact group sums ``p_d = sum_{t<=d} IA_t @ IB_{d-t}^T`` (both
    operands as K-contiguous rows), one float64 product per group over
    the K-concatenated slices: every partial sum is an integer below
    2^53, so the product is exact in any summation order (int8 products
    are not available on the card, and wrap on the CPU)."""
    s = ia.shape[0]
    for d in range(s):
        a = torch.cat([ia[t] for t in range(d + 1)], dim=-1).double()
        b = torch.cat([ib_rows[d - t] for t in range(d + 1)], dim=-1).double()
        yield d, a @ b.mT


def _fold(groups, shape, device):
    """The double-f32 fold of ``pallas_ozaki._fold_body``."""
    hi = torch.zeros(shape, dtype=torch.float32, device=device)
    lo = torch.zeros_like(hi)
    for d, p in groups:
        phi = p.float()
        plo = (p - phi.double()).float()
        scale = 2.0 ** (-SLICE_BITS * (d + 2))
        b = phi * scale
        s = hi + b
        bb = s - hi
        err = (hi - (s - bb)) + (b - bb)
        hi = s
        lo = lo + (err + plo * scale)
    return hi, lo


def ozaki_product_plain(ia: torch.Tensor, ib: torch.Tensor):
    """``(hi, lo)`` of the slice product (see :func:`ozaki_product`)."""
    m, n = ia.shape[1], ib.shape[2]
    return _fold(group_sums(ia, ib.mT), (m, n), ia.device)


def _zero_upper_blocks(x: torch.Tensor) -> torch.Tensor:
    m = x.shape[0]
    blk = torch.arange(m, device=x.device) // SYRK_BLOCK
    return x.masked_fill_(blk[None, :] > blk[:, None], 0.0)


def ozaki_syrk_plain(ia: torch.Tensor):
    """``(hi, lo)`` of the slice gram product (see :func:`ozaki_syrk`)."""
    m = ia.shape[1]
    hi, lo = _fold(group_sums(ia, ia), (m, m), ia.device)
    return _zero_upper_blocks(hi), _zero_upper_blocks(lo)


def ozaki_masked_product_plain(ia: torch.Tensor, ib: torch.Tensor, mode: torch.Tensor):
    """``(hi, lo)`` of the per-pair slice product (see
    :func:`ozaki_masked_product`): the whole rectangle, then the mode-0
    pairs zeroed."""
    s, R, bm, k = ia.shape
    C, bn = ib.shape[1], ib.shape[2]
    hi, lo = _fold(group_sums(ia.reshape(s, R * bm, k), ib.reshape(s, C * bn, k)),
                   (R * bm, C * bn), ia.device)
    live = (mode.to(ia.device) != 0)[:, :, None, None]
    return tuple(torch.where(live, x.reshape(R, bm, C, bn).permute(0, 2, 1, 3), 0.0)
                 for x in (hi, lo))


# ---------------------------------------------------------------------------
# Wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _require(ia: torch.Tensor, ib=None) -> None:
    """Check what the kernel takes: CUDA int8 stacks ``ia`` (s, M, K) and
    ``ib`` (s, K, N) on one device, 1..9 slices, K <= 1024."""
    for t in (ia,) if ib is None else (ia, ib):
        if not t.is_cuda:
            raise ValueError(f"ozaki kernels: expected a CUDA or CPU tensor, got {t.device}")
        if t.dtype != torch.int8 or t.dim() != 3:
            raise TypeError(f"ozaki kernels take 3-D int8 slice stacks, got {t.dtype} "
                            f"{tuple(t.shape)}")
    s, k = ia.shape[0], ia.shape[-1]
    if ib is not None and (ib.device != ia.device or tuple(ib.shape[:2]) != (s, k)):
        raise ValueError(f"ozaki_product: ia {tuple(ia.shape)} on {ia.device} and ib "
                         f"{tuple(ib.shape)} on {ib.device} do not match")
    if not 1 <= s <= MAX_SLICES:
        raise ValueError(f"ozaki kernels take 1..{MAX_SLICES} slices, got {s}")
    if k > K_MAX:
        raise ValueError(f"ozaki kernels take K <= {K_MAX}, got {k}")


def _k_rows(x: torch.Tensor) -> torch.Tensor:
    """Contiguous slices with K zero-padded to a multiple of 32 (zero
    slices add exactly nothing), starting on a 16-byte boundary (TMA's
    rule for a tensor's base address)."""
    pad = (-x.shape[-1]) % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@kernel_node(LAUNCHES, "ozaki_product")
@cb.on_device
def ozaki_product(ia: torch.Tensor, ib: torch.Tensor):
    """Fused all-shift Ozaki fold of stacked int8 slices ``ia`` (s, M, K)
    and ``ib`` (s, K, N): float32 ``(hi, lo)`` (M, N) with
    ``hi + lo ~= sum_{t+u=d<s} 2^-7(d+2) IA_t @ IB_u``; the caller applies
    ``*4*sa*sb`` in float64.

    Replaces ``pallas_ozaki.fused_slice_product``. Bound by the int8
    tensor-core operations: ``wgmma`` on 128 x 128 output tiles, shift
    outer (one int32 group sum per element, folded after each shift),
    operand chunks TMA-loaded into a 5-stage ring by a producer warp, one
    persistent block per SM."""
    if ia.device.type == "cpu":
        return ozaki_product_plain(ia, ib)
    _require(ia, ib)
    s, m, _ = ia.shape
    n = ib.shape[2]
    a, bt = _k_rows(ia), _k_rows(ib.mT)
    hi = torch.empty((m, n), dtype=torch.float32, device=ia.device)
    lo = torch.empty_like(hi)
    cb.check(LIBRARY.load().dlaf_oz_product(s, a.data_ptr(), bt.data_ptr(), m, n,
                                            a.shape[-1], hi.data_ptr(), lo.data_ptr(),
                                            cb.stream(ia)), "ozaki_product")
    LAUNCHES["ozaki_product"] += 1
    return hi, lo


@kernel_node(LAUNCHES, "ozaki_syrk")
@cb.on_device
def ozaki_syrk(ia: torch.Tensor):
    """Symmetric fused fold: float32 ``(hi, lo)`` (M, M) of ``IA @ IA^T``
    for stacked int8 slices ``ia`` (s, M, K), valid on the 256-row blocks
    on and below the block diagonal (whole blocks), zero above; the caller
    mirrors ``tril(H) + tril(H, -1)^T``.

    Replaces ``pallas_ozaki.fused_slice_syrk``. Same kernel as
    :func:`ozaki_product` with B = A; the tiles on and below the block
    diagonal come first in the persistent blocks' work list, the tiles
    above it are only written as zeros."""
    if ia.device.type == "cpu":
        return ozaki_syrk_plain(ia)
    _require(ia)
    s, m, _ = ia.shape
    a = _k_rows(ia)
    hi = torch.empty((m, m), dtype=torch.float32, device=ia.device)
    lo = torch.empty_like(hi)
    cb.check(LIBRARY.load().dlaf_oz_syrk(s, a.data_ptr(), m, a.shape[-1], SYRK_BLOCK,
                                         hi.data_ptr(), lo.data_ptr(), cb.stream(ia)),
             "ozaki_syrk")
    LAUNCHES["ozaki_syrk"] += 1
    return hi, lo


@kernel_node(LAUNCHES, "ozaki_masked_product")
@cb.on_device
def ozaki_masked_product(ia: torch.Tensor, ib: torch.Tensor, mode: torch.Tensor):
    """Per-tile-pair Ozaki fold, predicated on ``mode``: for int8 slices
    ``ia`` (s, R, bm, K) and ``ib`` (s, C, bn, K), float32 ``(hi, lo)``
    (R, C, bm, bn) with ``hi + lo ~= sum_{t+u=d<s} 2^-7(d+2) IA_t[r] @
    IB_u[c]^T`` where ``mode[r, c] != 0``, zeros where it is 0; the caller
    applies ``*4*sa*sb`` in float64 and its element masks.

    Replaces ``pallas_ozaki.masked_slice_product``. The same kernel as
    :func:`ozaki_product` over the tiles of every pair, the live pairs'
    first (found on the device from ``mode``); mode-0 pairs write zeros
    and skip their products."""
    if ia.device.type == "cpu":
        return ozaki_masked_product_plain(ia, ib, mode)
    if not (ia.is_cuda and ib.device == ia.device and mode.device == ia.device):
        raise ValueError(f"ozaki_masked_product: operands on {ia.device}, {ib.device}, "
                         f"{mode.device}")
    if ia.dtype != torch.int8 or ib.dtype != torch.int8 or ia.dim() != 4 or ib.dim() != 4:
        raise TypeError(f"ozaki_masked_product takes 4-D int8 slice stacks, got {ia.dtype} "
                        f"{tuple(ia.shape)} and {ib.dtype} {tuple(ib.shape)}")
    s, R, bm, k = ia.shape
    C, bn = ib.shape[1], ib.shape[2]
    if ib.shape[0] != s or ib.shape[3] != k or tuple(mode.shape) != (R, C):
        raise ValueError(f"ozaki_masked_product: ia {tuple(ia.shape)}, ib {tuple(ib.shape)}, "
                         f"mode {tuple(mode.shape)} do not match")
    if not 1 <= s <= MAX_SLICES:
        raise ValueError(f"ozaki kernels take 1..{MAX_SLICES} slices, got {s}")
    if max(bm, bn, k) > MASKED_MB_MAX:
        raise ValueError(f"ozaki_masked_product: tile edge {max(bm, bn, k)} > {MASKED_MB_MAX}")
    a, b = _k_rows(ia), _k_rows(ib)
    mode = mode.to(torch.int32).contiguous()
    hi = torch.empty((R, C, bm, bn), dtype=torch.float32, device=ia.device)
    lo = torch.empty_like(hi)
    cb.check(LIBRARY.load().dlaf_oz_masked(s, a.data_ptr(), b.data_ptr(), mode.data_ptr(), R, C,
                                           bm, bn, a.shape[-1], hi.data_ptr(), lo.data_ptr(),
                                           cb.stream(ia)), "ozaki_masked_product")
    LAUNCHES["ozaki_masked_product"] += 1
    return hi, lo
