"""dlaf_tpu_torch.obs: structured tracing, metrics and logging.

Port of ``dlaf_tpu/obs/`` less two offline analysers (``critpath``,
``devtrace``); the third, the artifact merger ``python -m
dlaf_tpu_torch.obs.aggregate``, is :mod:`.aggregate`. The knobs, layered like every other
:class:`dlaf_tpu_torch.config.Configuration` field (default < user struct
< env < ``--dlaf:`` argument):

* ``DLAF_LOG`` (``log``): leveled structured logging
  (debug/info/warning/error/off), :mod:`.logging`.
* ``DLAF_METRICS_PATH`` (``metrics_path``): JSON-lines artifact receiving
  span records, metrics snapshots, log events and resilience/serve
  records (:mod:`.sinks`; checked by ``python -m
  dlaf_tpu_torch.obs.validate``). Setting it turns the tracer and the
  metrics registry on. A ``%r`` in it becomes the process rank.
* ``DLAF_TRACE_DIR`` (``trace_dir``): one ``torch.profiler`` trace per
  process, written there as a Chrome trace; spans and the per-step
  :func:`named_span` phases then carry ``record_function`` names.
* ``DLAF_METRICS_PORT`` (``metrics_port``): the live ``/metrics`` and
  ``/healthz`` endpoint on 127.0.0.1 (:mod:`.exporter`).
* ``DLAF_SLO_P99_MS``, ``DLAF_SLO_WINDOW_S``, ``DLAF_SLO_BURST``: the
  rolling latency windows and burn counter (:mod:`.slo`).
* ``DLAF_FLIGHT_RECORDER``: the ring of the last N records, dumped on
  incidents (:mod:`.flight`).
* ``DLAF_ACCURACY`` (``accuracy``): the numerical-quality probes and their
  ``accuracy`` records (:mod:`.accuracy`), imported where they are used.
* ``DLAF_PROGRAM_TELEMETRY`` (``program_telemetry``): the first call of
  each distinct program at an instrumented site records its wall, the
  site's key count and its memory (:mod:`.telemetry`, ``program``
  records).

**Counting rule.** The reference counts collectives, Cholesky steps, tile
ops and D&C merges when a program is TRACED, once per compiled program.
Eager PyTorch traces nothing, so the port counts per CALL: once per verb
call or per step as it runs. After one fresh call the counters equal the
reference's after one fresh trace of the same builder; on a second call
the port's have doubled where the reference's (a cached program) have not.
A collective counts once per verb call on each process, its bytes one
rank's payload (``numel * element_size``), as the reference's per-device
operand.

Cost contract: with every knob off, each instrumented call site costs
one check of :data:`STATE` and resolves to a module-level no-op singleton,
with no allocation; a per-step ``named_span`` formats its name only while
a profiler is armed. The serve queue's trace and span IDs are drawn
whatever the knobs (one per ticket, one per dispatch), as the
reference's are.
"""

from __future__ import annotations

import atexit

from . import exporter as exporter
from . import flight as _flight
from . import logging as _logging
from . import metrics as _metrics
from . import sinks as _sinks
from . import slo as _slo
from . import telemetry as telemetry
from . import trace as _trace
from ._state import LOG_LEVELS, STATE, current_rank
from .context import (current_trace, new_span_id, new_trace_id,
                      single_trace_id, trace_context, trace_matches)
from .flight import FlightRecorder
from .logging import Logger, get_logger
from .metrics import (NOOP_COUNTER, NOOP_GAUGE, NOOP_HISTOGRAM, NOOP_WINDOW,
                      Counter, Gauge, Histogram, Registry, SlidingWindow,
                      prometheus_text, quantile)
from .sinks import (SCHEMA_VERSION, JsonlSink, expand_rank_template,
                    read_records, validate_file, validate_records)
from .trace import (NOOP_CTX, NOOP_SPAN, Span, current_span, entry_span,
                    named_span, scoped_step, span, start_profiler,
                    stop_profiler)

__all__ = [
    "configure", "enabled", "metrics_active", "span", "entry_span",
    "named_span", "scoped_step",
    "current_span", "counter", "gauge", "histogram", "registry",
    "get_logger", "emit_event", "emit_metrics_snapshot", "flush",
    "prometheus_text", "prometheus_snapshot_text", "validate_file",
    "validate_records", "read_records", "Span", "Counter", "Gauge",
    "Histogram", "Registry", "Logger", "JsonlSink", "SCHEMA_VERSION",
    "NOOP_SPAN", "NOOP_CTX", "NOOP_COUNTER", "NOOP_GAUGE", "NOOP_HISTOGRAM",
    "NOOP_WINDOW",
    "LOG_LEVELS", "start_profiler", "stop_profiler",
    "set_rank", "current_rank", "expand_rank_template",
    "trace_context", "current_trace", "new_trace_id", "new_span_id",
    "single_trace_id", "trace_matches", "observe_latency", "quantile",
    "SlidingWindow", "FlightRecorder", "exporter", "telemetry",
]


def configure(log_level: str = "info", metrics_path: str = "",
              trace_dir: str = "", program_telemetry: bool = False,
              metrics_port: int = 0, flight_recorder: int = 0) -> None:
    """(Re)configure the layer: called by ``config.initialize()`` with the
    resolved knobs, or lazily from the environment by the first logging
    call in a process that never initializes the configuration.

    Reconfiguring with a different ``metrics_path`` closes the old sink
    (its file stays, a complete artifact); counters persist across
    reconfiguration within a process: they are process-lifetime
    accumulators.

    ``metrics_path`` may carry a ``%r`` placeholder, replaced by the
    process rank (``torch.distributed.get_rank()`` once a process group
    exists) so each process of a multi-process run appends to its own
    artifact.

    ``metrics_port`` starts the live ``/metrics`` + ``/healthz`` exporter
    (:mod:`.exporter`) as a daemon thread on 127.0.0.1, and turns the
    registry on even without a sink. 0 (default): no thread, no socket.
    ``program_telemetry`` (``DLAF_PROGRAM_TELEMETRY``) arms the program
    records of :mod:`.telemetry` (and the registry, even without a sink);
    off, every telemetry site is a passthrough.
    ``flight_recorder`` arms a bounded ring of the last N sink records,
    dumped atomically to ``<metrics_path>.flight.jsonl`` on incident
    triggers (:mod:`.flight`); it needs a sink and warns once when armed
    without one.
    """
    level = str(log_level or "info").strip().lower()
    if level not in LOG_LEVELS:
        raise ValueError(f"DLAF_LOG={log_level!r}: must be one of "
                         f"{tuple(LOG_LEVELS)}")
    STATE.log_level = level
    STATE.log_level_num = LOG_LEVELS[level]
    metrics_path = _sinks.expand_rank_template(metrics_path or "")
    if STATE.sink is not None and STATE.sink.path != metrics_path:
        emit_metrics_snapshot()
        STATE.sink.close()
        STATE.sink = None
    if metrics_path and STATE.sink is None:
        STATE.sink = _sinks.JsonlSink(metrics_path)
    STATE.trace_dir = trace_dir or ""
    port = int(metrics_port or 0)
    if port < 0:
        raise ValueError(f"DLAF_METRICS_PORT={metrics_port!r}: must be "
                         ">= 0 (0 = exporter off)")
    STATE.metrics_on = STATE.sink is not None or port > 0
    STATE.annotate = bool(trace_dir)
    STATE.telemetry_on = bool(program_telemetry)
    if STATE.registry is None and (STATE.metrics_on or STATE.annotate
                                   or STATE.telemetry_on):
        STATE.registry = _metrics.Registry()
    # live exporter lifecycle: restart on a port change, stop on 0
    if port != STATE.exporter_port:
        exporter.stop()
        STATE.exporter_port = 0
        if port > 0:
            exporter.start(port)
            STATE.exporter_port = port
    cap = int(flight_recorder or 0)
    if cap < 0:
        raise ValueError(f"DLAF_FLIGHT_RECORDER={flight_recorder!r}: must "
                         "be >= 0 (0 = recorder off; N = ring depth)")
    if cap > 0 and STATE.sink is not None:
        if STATE.flight is None or STATE.flight.capacity != cap:
            STATE.flight = _flight.FlightRecorder(cap)
    else:
        STATE.flight = None
    if (STATE.metrics_on or STATE.annotate or STATE.telemetry_on) \
            and not STATE.atexit_registered:
        STATE.atexit_registered = True
        atexit.register(_shutdown)
    STATE.configured = True
    if cap > 0 and STATE.flight is None:
        # after ``configured``: the logger's lazy configure must not run
        # again from inside this one (it would recurse forever)
        get_logger("obs").warning_once(
            ("flight_no_sink",),
            "DLAF_FLIGHT_RECORDER is set but DLAF_METRICS_PATH is "
            "not: the flight ring captures the sink's record stream, "
            "so the recorder stays unarmed")


def set_rank(rank: int) -> None:
    """Pin the rank stamped onto JSONL records (and ``%r`` expansions).
    :func:`dlaf_tpu_torch.comm.multihost.initialize_multihost` calls this
    once its process group is up."""
    STATE.rank = int(rank)


def _shutdown() -> None:
    """Process exit: flush a final metrics snapshot, stop the profiler
    and the live exporter, so artifacts are complete even when a driver
    forgets to call flush()."""
    try:
        emit_metrics_snapshot()
    finally:
        _trace.stop_profiler()
        exporter.stop()
        STATE.exporter_port = 0
        if STATE.sink is not None:
            STATE.sink.close()


def enabled() -> bool:
    """True when any observability output is active."""
    return STATE.metrics_on or STATE.annotate


def metrics_active() -> bool:
    """Fast-path gate for instrumentation call sites (one attribute read)."""
    return STATE.metrics_on


def registry() -> Registry:
    """The process registry (created on first use; usable directly even
    with the sinks off)."""
    if STATE.registry is None:
        STATE.registry = _metrics.Registry()
    return STATE.registry


def counter(name: str, **labels):
    """Registry counter handle, or the no-op singleton when metrics are
    off."""
    if not STATE.metrics_on:
        return NOOP_COUNTER
    return STATE.registry.counter(name, **labels)


def gauge(name: str, **labels):
    if not STATE.metrics_on:
        return NOOP_GAUGE
    return STATE.registry.gauge(name, **labels)


def histogram(name: str, **labels):
    if not STATE.metrics_on:
        return NOOP_HISTOGRAM
    return STATE.registry.histogram(name, **labels)


def emit_event(rtype: str, **payload) -> None:
    """Append a free-form record to the JSONL artifact; no-op when the
    sink is off."""
    if STATE.sink is not None:
        rec = {"type": rtype}
        rec.update(payload)
        STATE.sink.write(rec)


def emit_metrics_snapshot() -> None:
    """Write the registry's current state as one ``metrics`` record."""
    if STATE.sink is not None and STATE.registry is not None:
        snap = STATE.registry.snapshot()
        if snap:
            STATE.sink.write({"type": "metrics", "metrics": snap})


def flush() -> None:
    """Snapshot metrics now (drivers call this at the end of a run so the
    artifact is complete without relying on interpreter shutdown)."""
    emit_metrics_snapshot()


def prometheus_snapshot_text() -> str:
    """Prometheus text exposition of the live registry, or "" when
    :func:`metrics_active` is false."""
    if not STATE.metrics_on or STATE.registry is None:
        return ""
    return prometheus_text(STATE.registry.snapshot())


def observe_latency(op: str, seconds: float, bucket: str = "") -> None:
    """Feed one end-to-end latency into the rolling-window SLO tracker
    (:mod:`.slo`): the ``dlaf_serve_latency_seconds{op,bucket}``
    histogram (with an exemplar trace ID under a request-scoped
    :func:`trace_context`), the ``dlaf_serve_latency_window{op,bucket,q}``
    gauges and the ``dlaf_slo_breach_total{op}`` burn counter against
    ``DLAF_SLO_P99_MS``. No-op when metrics are off."""
    if not STATE.metrics_on:
        return
    _slo.observe(str(op), float(seconds), bucket=str(bucket))


def _reset_for_tests() -> None:
    """Tear the layer back to the unconfigured default (tests only)."""
    try:
        _trace.stop_profiler()
    except Exception:
        pass
    if STATE.sink is not None:
        STATE.sink.close()
    exporter.stop()
    STATE.sink = None
    STATE.metrics_on = False
    STATE.annotate = False
    STATE.trace_dir = ""
    STATE.registry = None
    STATE.configured = False
    STATE.log_level = "info"
    STATE.log_level_num = LOG_LEVELS["info"]
    STATE.rank = None
    STATE.flight = None
    STATE.exporter_port = 0
    STATE.telemetry_on = False
    _slo.set_clock(None)
    _logging.reset_once()
    telemetry._reset_for_tests()
