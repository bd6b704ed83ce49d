"""Shift-retry recovery drivers for the Cholesky factorization.

Port of ``dlaf_tpu/health/recovery.py``. :func:`robust_cholesky` is the
policy layer above ``cholesky(..., with_info=True)``: the factorization
computes its info on the device with no host sync, and only a caller who
opts into recovery reads it back (one deliberate sync per attempt). On a
nonzero info it retries with a growing diagonal shift ``alpha * I``, the
standard modified-Cholesky response to an indefinite or barely definite
matrix, and on exhaustion raises :class:`.errors.FactorizationError`.
:func:`robust_cholesky_batched` does the same per lane of a batch,
re-dispatching only the failed lanes through the same warm bucket program.

Records, as the reference's (``recovery.py:89-330``): a span per attempt
(``robust_cholesky.attempt`` with its attempt, shift and info;
``robust_cholesky_batched.attempt`` with its lanes and failures), the
retries counted as ``dlaf_retry_total{algo="cholesky"}`` and per lane as
``{algo="cholesky_batched", lane}``, a failed finite guard as
``dlaf_check_failures_total{what}``, a warning per retry, and the flight
recorder's ``factorization_exhausted`` dump before the error is raised.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..types import dtype_name
from .errors import CheckError, FactorizationError
from .info import _diag_tile_coords
from .policy import RetryPolicy, attempts


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """Outcome of a successful :func:`robust_cholesky`: ``matrix`` holds
    the factor; ``attempts`` counts factorization attempts (1 = no
    recovery was needed); ``shifts``/``infos`` record each attempt's
    diagonal shift and info value (the last info is 0)."""

    matrix: object
    attempts: int
    shifts: tuple
    infos: tuple


def shift_diagonal(mat, alpha):
    """``mat + alpha * I`` as a new Matrix (same layout and grid), local
    or on a grid: each rank adds to the diagonal tiles it owns, the edge
    tile cut to the matrix size. With ``alpha == 0`` this is a fresh copy,
    which the retry loop's attempts consume so the original survives."""
    out = mat.clone()
    shards = out.shards()
    Q = mat.dist.grid_size.col
    for r, c, lr, lc, ts in _diag_tile_coords(mat.dist):
        s = shards[r * Q + c]
        torch.diagonal(s[lr, lc])[:ts].add_(torch.as_tensor(alpha, dtype=s.dtype,
                                                            device=s.device))
    return out


def _nonfinite(t: torch.Tensor) -> int:
    return int((~torch.isfinite(t)).sum())


def check_finite(what: str, mat) -> None:
    """Finite guard (``DLAF_CHECK``): raise :class:`.errors.CheckError`
    naming ``what`` when the matrix holds non-finite elements. Syncs with
    the host by design; callers gate it on the config knob."""
    count = sum(_nonfinite(s) for s in mat.shards())
    if count:
        obs.counter("dlaf_check_failures_total", what=what).inc()
        raise CheckError(what, count)


def checks_enabled() -> bool:
    """Is the opt-in finite guard on (``DLAF_CHECK``)?"""
    from ..config import get_configuration

    return bool(get_configuration().check)


def _validate(max_attempts, shift, shift_growth) -> None:
    if max_attempts < 1:
        raise ValueError(f"max_attempts={max_attempts}: must be >= 1")
    if shift is not None and not shift > 0:
        # 0 would alias the first-attempt sentinel: every retry would
        # repeat the unshifted factorization
        raise ValueError(f"shift={shift}: must be > 0 (or None for the "
                         "sqrt(eps)*max|A| default)")
    if not shift_growth > 1:
        raise ValueError(f"shift_growth={shift_growth}: must be > 1")


def _eps(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype.to_real()).eps)


def robust_cholesky(uplo: str, mat, *, max_attempts: int = 4, shift: Optional[float] = None,
                    shift_growth: float = 1e4) -> RecoveryResult:
    """Factorize ``mat`` with on-device failure detection and bounded
    shift-retry recovery.

    Attempt 0 runs unshifted. On a nonzero info (1-based first failing
    global column) the matrix is re-shifted from the ORIGINAL as ``A +
    alpha*I``, ``alpha`` starting at ``shift`` (default ``sqrt(eps) *
    max|A|``) and growing by ``shift_growth`` per retry, up to
    ``max_attempts`` attempts in all. Exhaustion raises
    :class:`.errors.FactorizationError`. With ``DLAF_CHECK=1`` the input
    and the factor also pass :func:`check_finite`. ``mat`` stays live
    across attempts; every attempt's working copy is donated."""
    from ..algorithms.cholesky import cholesky

    _validate(max_attempts, shift, shift_growth)
    if checks_enabled():
        check_finite("cholesky input", mat)
    n = mat.size.row
    alpha = 0.0
    shifts, infos = [], []
    log = obs.get_logger("health")
    policy = RetryPolicy(max_attempts=max_attempts, backoff_base_s=0.0)
    for a in attempts("robust_cholesky", policy, retry_labels=({"algo": "cholesky"},)):
        span = obs.span("robust_cholesky.attempt", attempt=a.index, shift=float(alpha), n=n,
                        uplo=uplo, dtype=dtype_name(mat.dtype))
        with span:
            work = shift_diagonal(mat, alpha)
            out, info_dev = cholesky(uplo, work, donate=True, with_info=True)
            info = int(info_dev)           # the recovery decision: one host sync
            span.set_attr("info", info)
        shifts.append(float(alpha))
        infos.append(info)
        if info == 0:
            if checks_enabled():
                check_finite("cholesky factor", out)
            return RecoveryResult(out, a.index + 1, tuple(shifts), tuple(infos))
        a.fail(reason=f"info={info}")
        if a.index + 1 < max_attempts:
            alpha = ((shift if shift is not None else _default_shift(mat)) if alpha == 0.0
                     else alpha * shift_growth)
            log.warning(f"cholesky info={info} (first failing global column) at attempt "
                        f"{a.index}; retrying with diagonal shift {alpha:.3e}", n=n,
                        uplo=uplo, attempt=a.index)
    # exhaustion is an incident: dump the flight ring (the retry records
    # are in it) before raising
    obs.flight.trigger("factorization_exhausted", algo="cholesky", attempts=max_attempts,
                       failing_column=int(infos[-1]))
    raise FactorizationError(failing_column=infos[-1], attempts=max_attempts,
                             shifts=tuple(shifts), infos=tuple(infos))


@dataclasses.dataclass(frozen=True)
class BatchRecoveryResult:
    """Outcome of a successful :func:`robust_cholesky_batched`: ``out``
    the ``(B, n, n)`` factor batch; ``attempts`` the most attempts any
    lane needed; ``lane_attempts`` per lane; ``shifts`` each attempt's
    shared shift (the first 0.0); ``infos`` each attempt's full-batch info
    vector (lanes already clean repeat their 0)."""

    out: object
    attempts: int
    lane_attempts: tuple
    shifts: tuple
    infos: tuple


def robust_cholesky_batched(uplo: str, a, *, nb: Optional[int] = None, max_attempts: int = 4,
                            shift: Optional[float] = None, shift_growth: float = 1e4,
                            service=None, device=None) -> BatchRecoveryResult:
    """Batched :func:`robust_cholesky`: factorize the ``(B, n, n)`` batch
    ``a`` (a tensor, or a host array moved to ``device``, by default the
    program service's) through
    :func:`..algorithms.batched.cholesky_batched` with per-LANE
    shift-retry recovery.

    Attempt 0 factors the whole batch unshifted. On nonzero lane infos
    ONLY the failed lanes are re-shifted from the ORIGINAL batch (``A_i +
    alpha*I``; ``alpha`` defaults to ``sqrt(eps) * max|A|`` over the batch
    and grows by ``shift_growth`` per retry) and re-dispatched as one
    batch through the SAME warm bucket program: the clean slots ride as
    identity pad lanes. Exhaustion raises
    :class:`.errors.FactorizationError` whose ``failing_column`` is the
    first still-failing lane's info and whose ``infos`` are every
    still-failing lane's final info. ``a`` is not changed."""
    from ..algorithms.batched import _as_batch, _service, cholesky_batched, default_nb

    _validate(max_attempts, shift, shift_growth)
    service = _service(service)
    a = _as_batch(a, device or service.device)
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"robust_cholesky_batched: expected a (B, n, n) batch, got shape "
                         f"{tuple(a.shape)}")
    if checks_enabled():
        count = _nonfinite(a)
        if count:
            obs.counter("dlaf_check_failures_total", what="cholesky_batched input").inc()
            raise CheckError("cholesky_batched input", count)
    b_, n = a.shape[0], a.shape[1]
    nb = nb if nb is not None else default_nb(n)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    log = obs.get_logger("health")
    alpha = 0.0
    shifts, infos_hist = [], []
    lane_attempts = np.zeros(b_, dtype=int)
    out = None
    failed = np.arange(b_)
    policy = RetryPolicy(max_attempts=max_attempts, backoff_base_s=0.0)
    for att in attempts("robust_cholesky_batched", policy):
        span = obs.span("robust_cholesky_batched.attempt", attempt=att.index,
                        shift=float(alpha), lanes=len(failed), batch=b_, n=n, uplo=uplo,
                        dtype=dtype_name(a.dtype))
        with span:
            # the donated working batch at the full bucket width: failed
            # lanes re-shifted from the original, the other slots identity
            # pad lanes
            work = eye.expand(b_, n, n).clone()
            idx = torch.as_tensor(failed, device=a.device)
            work[idx] = a[idx] + alpha * eye
            fac, info_dev = cholesky_batched(uplo, work, nb=nb, with_info=True, donate=True,
                                             service=service)
            info = info_dev.cpu().numpy()  # dlaf: disable=lint-host-sync(the one host sync per attempt: the policy decides on info)
            span.set_attr("failed", int(np.count_nonzero(info[failed])))
        lane_attempts[failed] += 1
        full_info = np.zeros(b_, dtype=info.dtype)
        full_info[failed] = info[failed]
        shifts.append(float(alpha))
        infos_hist.append(tuple(int(i) for i in full_info))
        newly_ok = failed[full_info[failed] == 0]
        if out is None:
            out = fac
        elif len(newly_ok):
            ok = torch.as_tensor(newly_ok, device=a.device)
            out[ok] = fac[ok]
        failed = failed[full_info[failed] != 0]
        if len(failed) == 0:
            return BatchRecoveryResult(out, attempts=int(lane_attempts.max(initial=1)),
                                       lane_attempts=tuple(int(x) for x in lane_attempts),
                                       shifts=tuple(shifts), infos=tuple(infos_hist))
        att.fail(reason=f"lanes={len(failed)}",
                 retry_labels=tuple({"algo": "cholesky_batched", "lane": int(lane)}
                                    for lane in failed))
        if att.index + 1 < max_attempts:
            if alpha == 0.0:
                amax = (float(a.abs().max()) if a.numel() else 0.0) or 1.0
                alpha = shift if shift is not None else float(np.sqrt(_eps(a.dtype))) * amax
            else:
                alpha *= shift_growth
            log.warning(f"cholesky_batched: {len(failed)} of {b_} lanes failed at attempt "
                        f"{att.index} (infos {[int(full_info[i]) for i in failed]}); retrying "
                        f"the subset with diagonal shift {alpha:.3e}", n=n, uplo=uplo,
                        attempt=att.index, lanes=len(failed))
    bad = [int(full_info[i]) for i in failed]
    obs.flight.trigger("factorization_exhausted", algo="cholesky_batched",
                       attempts=max_attempts, failing_column=bad[0], lanes=len(bad))
    raise FactorizationError(failing_column=bad[0], attempts=max_attempts,
                             shifts=tuple(shifts), infos=tuple(bad))


def _default_shift(mat) -> float:
    """Initial shift: ``sqrt(eps) * max|A|``, large enough to regularize
    rounding-level indefiniteness in one step, small enough to stay a
    perturbation."""
    eps = _eps(mat.dtype)
    amax = max((float(s.abs().max()) for s in mat.shards() if s.numel()), default=1.0)
    if not np.isfinite(amax) or amax == 0.0:
        amax = 1.0
    return float(np.sqrt(eps)) * amax
