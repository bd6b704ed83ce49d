"""Rolling-window SLO latency tracking.

Port of ``dlaf_tpu/obs/slo.py``. One entry point, :func:`observe` (exposed
as ``obs.observe_latency``): feed one end-to-end latency for ``(op,
bucket)`` and the module

* records it into ``dlaf_serve_latency_seconds{op,bucket}``, the
  cumulative histogram whose buckets carry exemplar trace IDs on the live
  ``/metrics`` endpoint, and its attached
  :class:`~.metrics.SlidingWindow` (a ring of fixed-size epoch buckets:
  bounded memory, deterministic under the injectable clock);
* refreshes the ``dlaf_serve_latency_window{op,bucket,q}`` gauges for q in
  {0.5, 0.95, 0.99} from the window (numpy-linear
  :func:`~.metrics.quantile`);
* counts one ``dlaf_slo_breach_total{op}`` when the latency exceeds the
  ``DLAF_SLO_P99_MS`` objective (0 = no objective, nothing counted): burn
  counting per observation, deterministic and monotone;
* trips the flight recorder with reason ``slo_breach_burst`` when at
  least ``DLAF_SLO_BURST`` breaches (default 5; 0 = off) land inside one
  SLO window for one op; the recorder's per-reason cooldown turns a
  sustained latency storm into ONE incident artifact. Breach stamps ride
  the same injectable clock as the windows.

The window length comes from ``DLAF_SLO_WINDOW_S``. Serve-queue request
completions and :func:`dlaf_tpu_torch.health.policy.with_policy`
successes record here (``op`` = the policy site for the latter). All
no-op when metrics are off (the facade gates before calling in).
"""

from __future__ import annotations

import time

#: Window quantiles exported as gauges, with their label spellings —
#: lexicographically ascending, which is also how the exposition sorts
#: them.
QUANTILES = ((0.5, "0.5"), (0.95, "0.95"), (0.99, "0.99"))

#: Histogram fed per observation (its window backs the gauges).
LATENCY_HISTOGRAM = "dlaf_serve_latency_seconds"

#: Gauge family holding the windowed quantiles.
WINDOW_GAUGE = "dlaf_serve_latency_window"

#: Counter of observations over the DLAF_SLO_P99_MS objective.
BREACH_COUNTER = "dlaf_slo_breach_total"

#: Injectable clock driving the epoch ring (tests pin expiry with a fake
#: clock; one module clock so every (op, bucket) window agrees on "now").
_clock = time.monotonic

#: Per-op breach timestamps inside the current SLO window (the
#: ``slo_breach_burst`` trigger state; pruned per observation, cleared
#: by :func:`set_clock`).
_breaches: dict = {}


def set_clock(clock=None) -> None:
    """Swap the window clock (tests); None restores ``time.monotonic``.
    Only windows created AFTER the swap use it — call before the first
    observation of the series under test. Clears the breach-burst
    stamps (they are meaningless across a clock swap)."""
    global _clock
    _clock = clock if clock is not None else time.monotonic
    _breaches.clear()


def _note_breach(op: str, cfg) -> None:
    """One over-objective observation: prune stamps older than the SLO
    window, and when the op's in-window breach count reaches
    ``slo_burst``, dump the flight ring (the recorder's per-reason
    cooldown dedups a storm into one artifact)."""
    burst = int(getattr(cfg, "slo_burst", 0) or 0)
    if burst <= 0:
        return
    window = max(float(cfg.slo_window_s), 1e-9)
    now = _clock()
    stamps = _breaches.setdefault(op, [])
    stamps.append(now)
    while stamps and now - stamps[0] > window:
        stamps.pop(0)
    if len(stamps) >= burst:
        from . import flight

        flight.trigger("slo_breach_burst", op=op, breaches=len(stamps),
                       window_s=window, burst=burst)


def observe(op: str, seconds: float, bucket: str = "") -> None:
    """Record one latency (module docstring). Callers gate on
    ``metrics_active()`` — this function assumes the registry is live."""
    from . import registry
    from ..config import get_configuration

    from .metrics import quantiles

    cfg = get_configuration()
    reg = registry()
    h = reg.histogram(LATENCY_HISTOGRAM, op=op, bucket=bucket)
    window = h.windowed(window_s=max(float(cfg.slo_window_s), 1e-9),
                        clock=_clock)
    h.observe(seconds)
    # one window copy + one sort for all three gauges (metrics.quantiles)
    vals = quantiles(window.samples(), [q for q, _ in QUANTILES])
    for (q, label), v in zip(QUANTILES, vals):
        reg.gauge(WINDOW_GAUGE, op=op, bucket=bucket, q=label).set(v)
    slo_ms = float(cfg.slo_p99_ms)
    if slo_ms > 0 and seconds * 1e3 > slo_ms:
        reg.counter(BREACH_COUNTER, op=op).inc()
        _note_breach(op, cfg)
