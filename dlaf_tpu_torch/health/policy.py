"""Declarative retry/timeout/backoff policy engine.

Port of ``dlaf_tpu/health/policy.py`` (docs/robustness.md §2), the one
engine that the recovery drivers and the serving dispatch share:

* :class:`RetryPolicy`: the total attempt budget, exponential backoff
  with DETERMINISTIC seeded jitter (the same policy and retry index give
  the same delay, so drills and tests replay exactly), a per-attempt
  deadline and the retryable-error classification;
* :func:`with_policy`: run an exception-deciding callable under a policy,
  optionally behind a :class:`.circuit.CircuitBreaker`: retryable
  failures re-run after the backoff, non-retryable ones raise at once,
  exhaustion re-raises the last error;
* :func:`attempts`: the outcome-deciding driver beneath ``with_policy``,
  for loops whose failure is data (a nonzero Cholesky info), not an
  exception.

Error classification (the reference's table): a caller bug or a health
decision (``ValueError``, ``TypeError``, ``AssertionError``, ``KeyError``,
``IndexError``, ``AttributeError``, ``NotImplementedError``, any
:class:`.errors.HealthError`) is never retried; any other ``Exception``
is retryable unless ``RetryPolicy(retryable=...)`` narrows it.

An attempt that returns after its deadline (measured with the injected
``clock``) raises :class:`.errors.DeadlineExceededError` without a retry:
the work is done and re-running it would be waste.

Records (reference ``policy.py:169-272``): each retry adds one to
``dlaf_retry_total`` per label dict (``{"site": site}`` unless the caller
names others) and writes a ``resilience`` retry record with its backoff;
exhaustion writes ``give_up``; a deadline breach adds one to
``dlaf_deadline_exceeded_total{site}`` and writes ``deadline``; each
success of :func:`with_policy` feeds its wall to
``obs.observe_latency(site, ...)``. All no-ops with metrics off.

Not ported yet: the injected stall ``inject.hang`` (the health-inject
port).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from .. import obs
from .errors import DeadlineExceededError, HealthError

#: Counter incremented once per retry (labels: site, or the caller's).
RETRY_COUNTER = "dlaf_retry_total"

#: Counter incremented once per per-attempt-deadline breach (labels: site).
DEADLINE_COUNTER = "dlaf_deadline_exceeded_total"

#: Exception families a retry can never fix (classification table above).
NON_RETRYABLE = (ValueError, TypeError, AssertionError, KeyError,
                 IndexError, AttributeError, NotImplementedError,
                 HealthError)


def default_retryable(exc: BaseException) -> bool:
    """The default classification: retry anything that is a plain
    ``Exception`` and not in :data:`NON_RETRYABLE`."""
    return isinstance(exc, Exception) and not isinstance(exc, NON_RETRYABLE)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """One site's declarative retry policy (module docstring).

    ``max_attempts`` is the TOTAL attempt budget (1 = no retry).
    ``backoff_base_s`` is the delay before the first retry, growing by
    ``backoff_growth`` per retry and capped at ``backoff_max_s``;
    ``jitter`` spreads each delay by up to +-``jitter`` fraction, drawn
    deterministically from ``(seed, retry index)``. ``attempt_deadline_s``
    bounds each attempt's wall clock (None = unbounded). ``retryable``
    overrides the default error classification (a predicate ``exc ->
    bool``)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.0
    backoff_growth: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.1
    seed: int = 0
    attempt_deadline_s: Optional[float] = None
    retryable: Optional[Callable[[BaseException], bool]] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"RetryPolicy.max_attempts={self.max_attempts}:"
                             " must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("RetryPolicy backoff bounds must be >= 0")
        if not self.backoff_growth >= 1:
            raise ValueError(f"RetryPolicy.backoff_growth="
                             f"{self.backoff_growth}: must be >= 1")
        if not 0 <= self.jitter < 1:
            raise ValueError(f"RetryPolicy.jitter={self.jitter}: must be "
                             "in [0, 1)")
        if self.attempt_deadline_s is not None \
                and not self.attempt_deadline_s > 0:
            raise ValueError(f"RetryPolicy.attempt_deadline_s="
                             f"{self.attempt_deadline_s}: must be > 0 "
                             "(or None for unbounded attempts)")

    def is_retryable(self, exc: BaseException) -> bool:
        pred = self.retryable if self.retryable is not None else default_retryable
        return bool(pred(exc))

    def delay_s(self, retry: int) -> float:
        """Backoff before retry number ``retry`` (0-based): exponential,
        capped, with the deterministic seeded jitter; a pure function of
        ``(policy, retry)``."""
        if self.backoff_base_s <= 0:
            return 0.0
        base = min(self.backoff_base_s * self.backoff_growth ** retry, self.backoff_max_s)
        if self.jitter <= 0:
            return base
        u = float(np.random.default_rng((int(self.seed), int(retry))).random())
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


class Attempt:
    """One attempt of an :func:`attempts` loop. The caller marks it
    failed (asking for another attempt) with :meth:`fail`; an attempt
    left unmarked ends the loop as a success."""

    def __init__(self, index: int):
        self.index = index
        self.failed = False
        self.reason = ""
        self.exc: Optional[BaseException] = None
        self.retry_labels: Optional[tuple] = None

    def fail(self, reason: str = "", exc: Optional[BaseException] = None,
             retry_labels: Optional[tuple] = None) -> None:
        """Mark this attempt failed. ``retry_labels`` (a tuple of label
        dicts) overrides the loop's retry-counter labels for THIS retry:
        one ``dlaf_retry_total`` increment per dict (the batched recovery
        counts per lane this way)."""
        self.failed = True
        self.reason = str(reason)
        self.exc = exc
        if retry_labels is not None:
            self.retry_labels = tuple(retry_labels)


def _emit(site: str, event: str, **fields) -> None:
    """One resilience JSONL record (no-op with the sink off)."""
    attrs = fields.pop("attrs", None) or {}
    obs.emit_event("resilience", site=site, event=event, attrs=attrs, **fields)


def attempts(site: str, policy: RetryPolicy, *,
             retry_labels: Optional[tuple] = None,
             sleep: Optional[Callable[[float], None]] = None):
    """Outcome-driven retry driver: yields :class:`Attempt` objects until
    the policy is exhausted or an attempt is left unmarked (success). On
    each marked failure with budget left it counts the retry once per
    label dict (``retry_labels``, default ``({"site": site},)``;
    overridable per attempt with :meth:`Attempt.fail`), writes a retry
    record and sleeps the policy backoff; exhaustion writes a ``give_up``
    record. Raising the site's contract error stays the caller's job."""
    sleep = time.sleep if sleep is None else sleep
    base_labels = tuple(retry_labels) if retry_labels is not None else ({"site": site},)
    for index in range(policy.max_attempts):
        a = Attempt(index)
        yield a
        if not a.failed:
            return
        if index + 1 < policy.max_attempts:
            for labels in (a.retry_labels or base_labels):
                obs.counter(RETRY_COUNTER, **labels).inc()
            delay = policy.delay_s(index)
            _emit(site, "retry", attempt=index, delay_s=float(delay),
                  attrs={"reason": a.reason} if a.reason else {})
            if delay > 0:
                sleep(delay)
        else:
            _emit(site, "give_up", attempt=index,
                  attrs={"reason": a.reason} if a.reason else {})


def with_policy(site: str, fn: Callable, *args,
                policy: Optional[RetryPolicy] = None,
                breaker=None,
                clock: Optional[Callable[[], float]] = None,
                sleep: Optional[Callable[[float], None]] = None,
                **kwargs):
    """Run ``fn(*args, **kwargs)`` under ``policy`` at ``site``; returns
    ``fn``'s result.

    Retryable failures re-run after the policy backoff; non-retryable
    ones raise at once; exhaustion re-raises the last error. ``breaker``
    (a :class:`.circuit.CircuitBreaker`) gates every attempt: an open
    breaker fails the call fast with :class:`.errors.CircuitOpenError`,
    and each attempt's outcome feeds it, so N consecutive attempt
    failures open it even within one call. The per-attempt deadline is
    measured with ``clock``; a success's wall feeds
    ``obs.observe_latency(site, ...)``."""
    clock = time.monotonic if clock is None else clock
    policy = policy if policy is not None else RetryPolicy()
    last: Optional[BaseException] = None
    for a in attempts(site, policy, sleep=sleep):
        if breaker is not None:
            breaker.allow()
        t0 = clock()
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:
            last = e
            if breaker is not None:
                breaker.record_failure()
            if not policy.is_retryable(e):
                raise
            a.fail(reason=type(e).__name__, exc=e)
            continue
        elapsed = clock() - t0
        if policy.attempt_deadline_s is not None and elapsed > policy.attempt_deadline_s:
            obs.counter(DEADLINE_COUNTER, site=site).inc()
            _emit(site, "deadline", attempt=a.index,
                  attrs={"elapsed_s": float(elapsed),
                         "deadline_s": float(policy.attempt_deadline_s)})
            if breaker is not None:
                breaker.record_failure()
            raise DeadlineExceededError(site, elapsed, policy.attempt_deadline_s,
                                        attempt=a.index)
        if breaker is not None:
            breaker.record_success()
        obs.observe_latency(site, elapsed)
        # drop the caught exception: its traceback references this frame
        # and would keep the guarded call's objects alive
        last = None
        return result
    assert last is not None  # attempts() only exhausts on marked failures
    raise last
