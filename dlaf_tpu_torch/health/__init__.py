"""dlaf_tpu_torch.health: failure detection and recovery.

Port of ``dlaf_tpu/health`` (docs/robustness.md), the parts the serving
layer needs: the info plumbing (:mod:`.info`), the structured errors
(:mod:`.errors`), the retry policy engine (:mod:`.policy`), the circuit
breakers (:mod:`.circuit`) and the shift-retry recovery drivers
(:mod:`.recovery`). The fault injection, degradation registry and
stage-resume modules are later ports.
"""

from __future__ import annotations

from . import circuit, info, policy, recovery  # noqa: F401
from .circuit import CircuitBreaker, breaker  # noqa: F401
from .errors import (AutotuneExhaustedError, CheckError, CircuitOpenError,  # noqa: F401
                     DeadlineExceededError, DegradationError, DrainedError,
                     FactorizationError, HealthError, OverloadError, PreemptionError,
                     ResumeError)
from .info import matrix_diag_info  # noqa: F401
from .policy import RetryPolicy, with_policy  # noqa: F401
from .recovery import (BatchRecoveryResult, RecoveryResult, check_finite,  # noqa: F401
                       robust_cholesky, robust_cholesky_batched, shift_diagonal)

__all__ = [
    "AutotuneExhaustedError", "BatchRecoveryResult", "CheckError", "CircuitBreaker",
    "CircuitOpenError", "DeadlineExceededError", "DegradationError", "DrainedError",
    "FactorizationError", "HealthError", "OverloadError", "PreemptionError",
    "RecoveryResult", "ResumeError", "RetryPolicy", "breaker", "check_finite", "circuit",
    "info", "matrix_diag_info", "policy", "recovery", "robust_cholesky",
    "robust_cholesky_batched", "shift_diagonal", "with_policy",
]
