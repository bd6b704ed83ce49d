"""The one degradation policy of the port's fallback sites.

Port of ``dlaf_tpu/health/registry.py`` (docs/robustness.md). Every site
that can take a degraded path decides it here:

* each degradation adds one to ``dlaf_fallback_total{site,reason}``
  (:mod:`..obs`: the JSONL artifact and the Prometheus exposition) and is
  announced once per (site, reason) through the ``health`` logger, so a
  run never degrades in silence;
* strict mode (``DLAF_STRICT=1``, config ``strict``) turns every
  degradation into a :class:`.errors.DegradationError`: the stance of a CI
  or bring-up run, where a missing native library must fail the job.

The port's sites, under the reference's names: ``secular``, ``deflate``
and ``band_to_tridiag`` (the native host code of the D&C merge and of the
chase -> their numpy twins, when the library cannot be built or loaded);
``panel`` and ``step`` (an explicitly asked fused route that does not
apply, or one a drill closed -> the composed route); ``pallas_update``
and ``ozaki_pallas`` (the update and pair kernels, closed by a drill);
``ozaki_gemm`` (the Ozaki product route, closed by a drill). A CUDA
kernel's failure to build or launch is never one of them: it raises.

Route *policy* (an ``auto`` that resolves elsewhere, the
``f64_gemm_min_dim`` gate) is configuration, not degradation, and is not
counted here.

:func:`fallback_counts` is the process's own tally of the same counts,
kept whether or not metrics are on (``dlaf_fallback_total`` is a no-op
with them off); ``chip_smoke.py`` reads it.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import obs
from .errors import DegradationError

#: Counter name shared by every degradation site (labels: site, reason).
FALLBACK_COUNTER = "dlaf_fallback_total"

_TALLY: dict = {}
_TALLY_LOCK = threading.Lock()


def strict_mode() -> bool:
    """Is strict mode on (``DLAF_STRICT``)? Strict forbids degradation:
    :func:`report_fallback` raises instead of recording and continuing."""
    from ..config import get_configuration

    return bool(get_configuration().strict)


def fallback_counts() -> dict:
    """``{(site, reason): count}`` of this process's degradations so far
    (strict raises included: they are counted before the raise)."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def report_fallback(site: str, reason: str, *, exc: Optional[BaseException] = None,
                    detail: str = "") -> None:
    """Record one degradation at ``site`` (counter and one-shot warning);
    raise :class:`DegradationError` in strict mode.

    ``exc`` is the triggering exception, if any: chained onto the strict
    error and named in the announcement. Call this exactly when the
    fallback is decided; the caller then takes its degraded path (unless
    this raised)."""
    with _TALLY_LOCK:
        _TALLY[(site, reason)] = _TALLY.get((site, reason), 0) + 1
    obs.counter(FALLBACK_COUNTER, site=site, reason=reason).inc()
    why = detail or (repr(exc) if exc is not None else "")
    obs.get_logger("health").warning_once(
        (site, reason),
        f"degraded path at {site!r} ({reason})" + (f": {why}" if why else "")
        + " — counting under dlaf_fallback_total; DLAF_STRICT=1 raises instead",
        site=site, reason=reason)
    if strict_mode():
        err = DegradationError(site, reason, why)
        if exc is not None:
            raise err from exc
        raise err


def run_with_fallback(site: str, primary: Callable, fallback: Callable, *,
                      expected: type = Exception):
    """Run ``primary()``; on ``expected`` record the degradation (reason
    ``native_unavailable``) and run ``fallback()`` (the native chase and
    secular sites). Strict mode raises from inside
    :func:`report_fallback`, so the fallback never runs there.

    A per-site circuit breaker (``fallback.<site>``, :mod:`.circuit`) rides
    the chain: after ``DLAF_CIRCUIT_THRESHOLD`` consecutive primary
    failures it opens and the primary is skipped (counted under reason
    ``circuit_open``) until the cooldown's half-open probe. The injection
    contexts reset the ``fallback.*`` breakers on exit, so a drill never
    leaves one open for later calls."""
    from . import circuit
    from .errors import CircuitOpenError

    br = circuit.breaker(f"fallback.{site}")
    try:
        br.allow()
    except CircuitOpenError as e:
        report_fallback(site, "circuit_open", exc=e)
        return fallback()
    try:
        result = primary()
    except expected as e:
        br.record_failure()
        report_fallback(site, "native_unavailable", exc=e)
        return fallback()
    except BaseException:
        # an unexpected error still settles the breaker's probe slot: a
        # stuck half-open probe would reject every later call
        br.record_failure()
        raise
    br.record_success()
    return result


def route_available(name: str, site: str) -> bool:
    """The injection gate of the route deciders (``ozaki_gemm``,
    ``pallas_update``, ``ozaki_pallas``, ``panel``, ``step``): called ONLY
    after the route's own policy said yes. False, with the degradation
    counted at ``site``, when :func:`.inject.disable_route` closed
    ``name``."""
    from .inject import route_disabled

    if route_disabled(name):
        report_fallback(site, "injected_off")
        return False
    return True
