"""dlaf_tpu_torch.health: failure detection, recovery, injection,
degradation and resume.

Port of ``dlaf_tpu/health`` (docs/robustness.md): the info plumbing
(:mod:`.info`), the structured errors (:mod:`.errors`), the retry policy
engine (:mod:`.policy`), the circuit breakers (:mod:`.circuit`), the
shift-retry recovery (:mod:`.recovery`), the deterministic fault
injection (:mod:`.inject`), the one degradation policy of every fallback
site with its ``dlaf_fallback_total{site,reason}`` counter and strict mode
(:mod:`.registry`, ``DLAF_STRICT``), and the eigensolver's stage
checkpoints and resume (:mod:`.resume`, ``DLAF_RESUME_DIR``).
"""

from __future__ import annotations

from . import circuit, info, inject, policy, recovery, registry, resume  # noqa: F401
from .circuit import CIRCUIT_GAUGE, CircuitBreaker, breaker  # noqa: F401
from .errors import (AutotuneExhaustedError, CheckError, CircuitOpenError,  # noqa: F401
                     DeadlineExceededError, DegradationError, DrainedError,
                     FactorizationError, HealthError, OverloadError, PreemptionError,
                     ResumeError)
from .info import matrix_diag_info  # noqa: F401
from .policy import DEADLINE_COUNTER, RETRY_COUNTER, RetryPolicy, with_policy  # noqa: F401
from .recovery import (BatchRecoveryResult, RecoveryResult, check_finite,  # noqa: F401
                       robust_cholesky, robust_cholesky_batched, shift_diagonal)
from .registry import (FALLBACK_COUNTER, report_fallback, route_available,  # noqa: F401
                       run_with_fallback, strict_mode)

__all__ = [
    "AutotuneExhaustedError", "BatchRecoveryResult", "CIRCUIT_GAUGE", "CheckError",
    "CircuitBreaker", "CircuitOpenError", "DEADLINE_COUNTER", "DeadlineExceededError",
    "DegradationError", "DrainedError", "FALLBACK_COUNTER", "FactorizationError",
    "HealthError", "OverloadError", "PreemptionError", "RETRY_COUNTER", "RecoveryResult",
    "ResumeError", "RetryPolicy", "breaker", "check_finite", "circuit", "info", "inject",
    "matrix_diag_info", "policy", "recovery", "registry", "report_fallback", "resume",
    "robust_cholesky", "robust_cholesky_batched", "route_available", "run_with_fallback",
    "shift_diagonal", "strict_mode", "with_policy",
]
