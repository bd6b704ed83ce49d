"""Batched many-problem entry points (leading batch axis).

Port of ``dlaf_tpu/algorithms/batched.py``: the serving regime is millions
of small solve, factor and EVP requests, where per-request dispatch cost,
not arithmetic, bounds throughput. One bucket program factors, solves or
diagonalizes a whole ``(B, n, n)`` batch per dispatch, served warm from the
:mod:`..serve` program cache.

* :func:`cholesky_batched`: per-lane Cholesky over the ``uplo`` triangle,
  the local builder's whole-matrix "xla" route (other triangle passed
  through) on a batch: one ``torch.linalg.cholesky_ex``.
* :func:`solve_batched`: per-lane triangular solve (every
  side/uplo/op/diag, per-lane ``alpha``), the batched ``_solve_local``.
* :func:`eigh_batched`: per-lane Hermitian eigendecomposition of the
  ``uplo`` triangle (ascending eigenvalues and eigenvector columns).

Lane-parity contract (docs/serving.md): lane i of a B-lane dispatch equals
the B=1 dispatch of the same op, bitwise, so pad lanes are inert. The
library's batched routines are not batch-size-invariant on the card: ATen
picks its cuSOLVER/cuBLAS path by the batch count (a single ``potrf`` at
B=1 and ``potrfBatched`` above it; a looped ``trsm`` up to 8 lanes and
``trsmBatched`` above it from n=64; a batched Jacobi ``eigh`` for n <= 32
above B=1), and the paths round differently (PERF.md §6). So on the card
no library call of a bucket program sees fewer than :data:`MIN_LANES`
lanes: a shorter batch is padded with inert lanes (identity matrices,
zero right-hand sides). Above that count the batched Cholesky and eigh
compute every lane the same at any batch count (measured up to 4096
lanes by ``python -m dlaf_tpu_torch.serve.lane_probe``), so they make
one call; the batched solve does not (its lanes at 64 or 256 differ from
those at 16 in float32 and complex128 from n=128), so it is cut into
calls of exactly :data:`MIN_LANES` lanes. On the CPU, LAPACK factors lane
by lane whatever the batch, and the lanes go to the library as they are.

``with_info=True`` adds a per-lane int32 info VECTOR ``(B,)``: 0 per
clean lane, else the 1-based first failing (singular, non-finite) column
of that lane. :func:`..health.recovery.robust_cholesky_batched` is the
recovery driver over it.

Entry points take a tensor (its device is used) or a host array (moved to
``device``, by default the program service's, whose default is ``cuda``).
Each writes the reference's unfenced entry span (``cholesky_batched``,
``solve_batched``, ``eigh_batched``; ``batched.py:156, 198, 223``) with
its flop model when :mod:`..obs` records.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..common.asserts import dlaf_assert
from ..health import info as hinfo
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl
from ..types import dtype_name, total_ops
from .cholesky import _whole_matrix

#: Default block size of the batched bucket programs. The whole-matrix
#: routes do not block, but ``nb`` stays a bucket-key member as in the
#: reference.
DEFAULT_NB = 256

#: The fewest lanes a library call of a bucket program sees, per device
#: type (None: the batch as it is): on cuda one path of ATen's
#: batch-count heuristics for a bucket at any B.
MIN_LANES = {"cuda": 16, "cpu": None}


def default_nb(n: int) -> int:
    return max(1, min(int(n), DEFAULT_NB))


def _fixed_lanes(fn, *xs: torch.Tensor, pads, split: bool = False):
    """``fn(*xs)`` over the leading lane axis with at least
    ``MIN_LANES[device]`` lanes per call: a shorter batch padded with
    ``pads`` (one inert lane per operand); with ``split`` every call gets
    exactly that many, the last one padded. The outputs (a tensor or a
    tuple of them) joined and cut back to the lanes of ``xs``."""
    k = MIN_LANES.get(xs[0].device.type)
    B = xs[0].shape[0]
    if not k or (B >= k and not split):
        return fn(*xs)
    outs = []
    for c0 in range(0, B, k if split else B):
        chunk = [x[c0:c0 + k] for x in xs]
        short = k - chunk[0].shape[0]
        if short > 0:
            chunk = [torch.cat([x, p.expand(short, *p.shape)]) for x, p in zip(chunk, pads)]
        outs.append(fn(*chunk))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:B] for parts in zip(*outs))
    return torch.cat(outs)[:B]


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


# ---------------------------------------------------------------------------
# The lane programs (what a bucket program runs on its (B, n, n) batch)
# ---------------------------------------------------------------------------

def cholesky_one(a: torch.Tensor, *, uplo: str, nb: int, with_info: bool = False,
                 donate: bool = False):
    """The batched Cholesky of ``a`` ``(B, n, n)``: the local builder's
    whole-matrix "xla" route on every lane (triangle pass-through, NaN
    from a lane's first failing column on), plus the per-lane info vector
    of ``cholesky(..., with_info=True)``. ``donate`` writes the factor
    into ``a``. ``nb`` is a bucket-key member only."""
    eye = _eye_like(a)
    out = _whole_matrix(a, uplo, out=a if donate else None,
                        factor=lambda af: _fixed_lanes(tl._chol_lower_nan, af, pads=(eye,)))
    if not with_info:
        return out
    return out, hinfo.first_bad_info(hinfo.bad_diag_mask(torch.diagonal(out, dim1=-2, dim2=-1)))


def solve_one(a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor, *, side: str,
              uplo: str, op: str, diag: str, with_info: bool = False, donate: bool = False):
    """The batched triangular solve: ``op(A_i) X_i = alpha_i B_i``
    (side='L') or ``X_i op(A_i) = alpha_i B_i`` ('R') over the ``uplo``
    triangles of ``a`` ``(B, n, n)``, ``alpha`` a ``(B,)`` vector.
    ``with_info`` adds the singular-diagonal info (a zero or non-finite
    diagonal entry; 0 for unit-diagonal solves, which never read the
    diagonal). ``donate`` writes the solution into ``b``."""
    rhs = alpha[:, None, None] * b
    x = _fixed_lanes(lambda aa, bb: tb._trsm_native(side, uplo, op, diag, aa, bb), a, rhs,
                     pads=(_eye_like(a), torch.zeros_like(rhs[0])), split=True)
    if donate:
        x = b.copy_(x)
    if not with_info:
        return x
    if diag == "U":
        info = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    else:
        info = hinfo.first_bad_info(hinfo.bad_diag_mask(torch.diagonal(a, dim1=-2, dim2=-1),
                                                        singular=True))
    return x, info


def eigh_one(a: torch.Tensor, *, uplo: str, with_info: bool = False, donate: bool = False):
    """The batched Hermitian eigensolver: eigenvalues (ascending) and
    eigenvector columns of the matrices whose ``uplo`` triangles ``a``
    ``(B, n, n)`` stores (the other triangle is not read: the Hermitian
    expansion is built explicitly). ``with_info`` flags non-finite
    eigenvalues (1-based first bad index). ``donate`` writes the
    eigenvectors into ``a``."""
    if uplo == "L":
        ah = torch.tril(a) + torch.tril(a, -1).mH
    else:
        ah = torch.triu(a) + torch.triu(a, 1).mH
    w, v = _fixed_lanes(torch.linalg.eigh, ah, pads=(_eye_like(a),))
    if donate:
        v = a.copy_(v)
    if not with_info:
        return w, v
    return w, v, hinfo.first_bad_info(~torch.isfinite(w))


# ---------------------------------------------------------------------------
# Public batched entry points
# ---------------------------------------------------------------------------

def _service(service):
    from ..serve.programs import get_service

    return service if service is not None else get_service()


def _as_batch(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, a host array on ``device``."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)


def _check_batch(a, what: str) -> tuple:
    dlaf_assert(hasattr(a, "ndim") and a.ndim == 3,
                f"{what}: expected a (B, n, n) batch, got shape {getattr(a, 'shape', None)}")
    b_, n, n2 = a.shape
    dlaf_assert(n == n2, f"{what}: lanes must be square, got {tuple(a.shape)}")
    dlaf_assert(b_ >= 1, f"{what}: empty batch")
    return b_, n


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def cholesky_batched(uplo: str, a, *, nb: int = None, with_info: bool = False,
                     donate: bool = False, service=None, device=None):
    """Cholesky-factorize every lane of the ``(B, n, n)`` batch ``a`` in
    its ``uplo`` triangle with one bucket program from the :mod:`..serve`
    program cache. Returns the ``(B, n, n)`` factor batch (the other
    triangle passes through), and the per-lane int32 info vector with
    ``with_info``. ``donate=True`` lets the program write into ``a``'s
    storage; ``a`` must not be used afterwards. With ``donate=False``
    ``a`` is not changed."""
    from ..serve.programs import cholesky_spec

    dlaf_assert(uplo in ("L", "U"), f"cholesky_batched: uplo must be 'L' or 'U', got {uplo!r}")
    svc = _service(service)
    a = _as_batch(a, device or svc.device)
    b_, n = _check_batch(a, "cholesky_batched")
    spec = cholesky_spec(batch=b_, n=n, nb=nb or default_nb(n), dtype=_dtype_name(a),
                         uplo=uplo, with_info=with_info, donate=donate)
    with obs.entry_span("cholesky_batched", lambda: dict(
            flops=b_ * total_ops(a.dtype, n ** 3 / 6, n ** 3 / 6), batch=b_, n=n, nb=spec.nb,
            uplo=uplo, dtype=dtype_name(a.dtype))):
        return svc.run(spec, a)


def solve_batched(side: str, uplo: str, op: str, diag: str, alpha, a, b, *, nb: int = None,
                  with_info: bool = False, donate_b: bool = False, service=None,
                  device=None):
    """Triangular-solve every lane: ``op(A_i) X_i = alpha_i B_i``
    (side='L') or ``X_i op(A_i) = alpha_i B_i`` (side='R') for the
    ``(B, n, n)`` triangle batch ``a`` and the ``(B, n, nrhs)`` (side 'L';
    ``(B, nrhs, n)`` side 'R') right-hand sides ``b``, one bucket program
    per (n, nrhs, dtype, side/uplo/op/diag). ``alpha`` is a scalar or a
    per-lane ``(B,)`` vector (never part of the bucket key).
    ``with_info=True`` adds the per-lane singular-diagonal info vector;
    ``donate_b=True`` lets the solution take ``b``'s storage."""
    for name, val, choices in (("side", side, ("L", "R")), ("uplo", uplo, ("L", "U")),
                               ("op", op, ("N", "T", "C")), ("diag", diag, ("N", "U"))):
        dlaf_assert(val in choices, f"solve_batched: {name} must be one of {choices}, "
                    f"got {val!r}")
    from ..serve.programs import solve_spec

    svc = _service(service)
    a = _as_batch(a, device or svc.device)
    b = _as_batch(b, a.device)
    b_, n = _check_batch(a, "solve_batched")
    dlaf_assert(b.ndim == 3 and b.shape[0] == b_,
                f"solve_batched: rhs must be (B, ., .) with B={b_}, got shape {tuple(b.shape)}")
    solve_dim = b.shape[1] if side == "L" else b.shape[2]
    nrhs = b.shape[2] if side == "L" else b.shape[1]
    dlaf_assert(solve_dim == n, f"solve_batched: rhs solve dimension {solve_dim} != n={n}")
    spec = solve_spec(batch=b_, n=n, nrhs=nrhs, nb=nb or default_nb(n), dtype=_dtype_name(a),
                      side=side, uplo=uplo, transa=op, diag=diag, with_info=with_info,
                      donate=donate_b)
    alpha_vec = torch.as_tensor(alpha, dtype=a.dtype).to(a.device).expand(b_)
    with obs.entry_span("solve_batched", lambda: dict(
            flops=b_ * total_ops(a.dtype, n ** 2 * nrhs / 2, n ** 2 * nrhs / 2), batch=b_, n=n,
            nrhs=nrhs, nb=spec.nb, side=side, uplo=uplo, op=op, diag=diag,
            dtype=dtype_name(a.dtype))):
        return svc.run(spec, a, b, alpha_vec)


def eigh_batched(uplo: str, a, *, nb: int = None, with_info: bool = False,
                 donate: bool = False, service=None, device=None):
    """Eigendecompose every Hermitian lane of the ``(B, n, n)`` batch
    ``a`` (``uplo`` triangle stored; the other is not read) with one
    bucket program. Returns ``(w, v)``: eigenvalues ``(B, n)`` ascending
    and eigenvector columns ``(B, n, n)``, and the per-lane
    non-finite-eigenvalue info vector with ``with_info``."""
    from ..serve.programs import eigh_spec

    dlaf_assert(uplo in ("L", "U"), f"eigh_batched: uplo must be 'L' or 'U', got {uplo!r}")
    svc = _service(service)
    a = _as_batch(a, device or svc.device)
    b_, n = _check_batch(a, "eigh_batched")
    spec = eigh_spec(batch=b_, n=n, nb=nb or default_nb(n), dtype=_dtype_name(a), uplo=uplo,
                     with_info=with_info, donate=donate)
    with obs.entry_span("eigh_batched", lambda: dict(
            flops=b_ * total_ops(a.dtype, 5 * n ** 3 / 3, 5 * n ** 3 / 3), batch=b_, n=n,
            nb=spec.nb, uplo=uplo, dtype=dtype_name(a.dtype))):
        return svc.run(spec, a)
