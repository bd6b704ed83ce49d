"""Element types and the flop-weight model.

Counterpart of ``dlaf_tpu/types.py`` (reference ``include/dlaf/types.h``):
``SizeType``, the ``Device`` and ``Backend`` enums with their default
maps, the s/d/c/z element types the miniapps name, ``total_ops``, the
real-op count used for GFlop/s (a complex multiply counts 6, a complex
add 2), and the scan builders' ``telescope_segments`` and
``telescope_windows``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

#: Signed size type of element and tile indices (reference ``types.h:24-28``,
#: ``std::ptrdiff_t``); Python ints are unbounded, the alias names intent.
SizeType = int


class Device(enum.Enum):
    """Where data lives (reference ``types.h:30-38``): the host or a CUDA
    card (the reference's TPU)."""

    CPU = "cpu"
    CUDA = "cuda"

    def __str__(self) -> str:
        return self.value


class Backend(enum.Enum):
    """Which backend runs the kernels (reference ``types.h:40-60``): ``MC``
    the host, ``GPU`` a CUDA card (the reference maps ``Backend::GPU`` to
    its TPU)."""

    MC = "mc"
    GPU = "gpu"

    def __str__(self) -> str:
        return self.value


def default_device(backend: Backend) -> Device:
    """``DefaultDevice_v`` (reference ``types.h:75-90``)."""
    return {Backend.MC: Device.CPU, Backend.GPU: Device.CUDA}[backend]


def default_backend(device: Device) -> Backend:
    """``DefaultBackend_v`` (reference ``types.h:92-106``)."""
    return {Device.CPU: Backend.MC, Device.CUDA: Backend.GPU}[device]


#: The four scalar types every algorithm is instantiated over, keyed by the
#: BLAS letter the miniapps use.
ELEMENT_TYPES = {
    "s": np.float32,
    "d": np.float64,
    "c": np.complex64,
    "z": np.complex128,
}

_LETTER = {np.dtype(v): k for k, v in ELEMENT_TYPES.items()}

_TORCH_OF = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (or a torch dtype, passed through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF[np.dtype(dtype)]


def type_letter(dtype) -> str:
    """BLAS letter (s/d/c/z) for a dtype, used in benchmark output lines."""
    if isinstance(dtype, torch.dtype):
        dtype = {v: k for k, v in _TORCH_OF.items()}[dtype]
    return _LETTER[np.dtype(dtype)]


def is_complex(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_complex
    return np.dtype(dtype).kind == "c"


def base_float(dtype):
    """The real scalar type under ``dtype`` (the reference's ``BaseType``),
    in ``dtype``'s kind: a numpy type for a numpy dtype, a torch dtype for
    a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.to_real()
    return np.dtype(dtype).type(0).real.dtype.type


def complex_of(dtype):
    """The complex scalar type of ``dtype``'s precision."""
    if isinstance(dtype, torch.dtype):
        return dtype.to_complex()
    return {np.float32: np.complex64, np.float64: np.complex128}[base_float(dtype)]


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ("float64", "complex128"),
    as the reference's records spell it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def ops_weights(dtype) -> tuple[int, int]:
    """(add, mul) weights in real flops of one addition and one
    multiplication of ``dtype`` (reference ``types.h:120-131``)."""
    return (2, 6) if is_complex(dtype) else (1, 1)


def total_ops(dtype, add: float, mul: float) -> float:
    """Total real-op count for ``add`` additions and ``mul``
    multiplications (:func:`ops_weights`)."""
    wa, wm = ops_weights(dtype)
    return wa * add + wm * mul


def ceil_div(num: int, den: int) -> int:
    """Integer ceiling division."""
    if den <= 0:
        raise ValueError(f"ceil_div: denominator must be positive, got {den}")
    if num < 0:
        raise ValueError(f"ceil_div: numerator must be non-negative, got {num}")
    return -(-num // den)


def telescope_segments(steps: int, min_chunk: int = 8, max_segments: int = 8):
    """Segment lengths of the telescoped scan builder: EQUAL chunks of
    ``max(min_chunk, ceil(steps / max_segments))`` steps, the last one
    ragged. Each segment runs its uniform masked steps on the shrinking
    trailing block, so the masked work tracks the live block (about
    1.29x the exact cubic work at 64 steps instead of 3x for one
    full-size segment). Copy of ``dlaf_tpu/types.py:telescope_segments``."""
    if steps <= 0:
        return ()
    c = max(min_chunk, -(-steps // max_segments))
    segs = [c] * (steps // c)
    if steps % c:
        segs.append(steps % c)
    return tuple(segs)


def telescope_windows(steps: int, window_fn):
    """Coalesced ``(window, start, length)`` segments of the telescoped
    scan builders (distributed Cholesky, triangular solve and multiply):
    ``window_fn(start, length)`` maps a segment of
    :func:`telescope_segments` to a hashable window (slot offsets and
    extents), and adjacent segments with equal windows merge into one.
    Copy of ``dlaf_tpu/types.py:telescope_windows``."""
    segs = []
    pos = 0
    for seg_len in telescope_segments(steps):
        win = window_fn(pos, seg_len)
        if segs and segs[-1][0] == win:
            segs[-1] = (win, segs[-1][1], segs[-1][2] + seg_len)
        else:
            segs.append((win, pos, seg_len))
        pos += seg_len
    return segs
