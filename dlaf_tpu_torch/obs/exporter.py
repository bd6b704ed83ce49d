"""Live ``/metrics`` + ``/healthz`` endpoint.

Port of ``dlaf_tpu/obs/exporter.py``. A stdlib ``http.server`` daemon
thread, armed by ``DLAF_METRICS_PORT`` (0 = off: no thread, no socket),
bound to ``127.0.0.1`` (the library never opens a public socket). Two
routes:

* ``GET /metrics``: Prometheus text exposition of the LIVE registry. A
  client whose ``Accept`` header names ``application/openmetrics-text``
  gets the OpenMetrics rendering (exemplar trace IDs on the latency
  histogram's buckets, :func:`.metrics.prometheus_text` with
  ``exemplars=True``, and the ``# EOF`` terminator); everyone else gets
  classic 0.0.4 text with no exemplar clause, which that grammar lacks.
* ``GET /healthz``: one JSON object: each registered queue's
  ``Queue.stats()`` (exactly the structure the method returns), every
  circuit breaker's state, the worst live ``dlaf_accuracy_ratio`` gauge
  (``accuracy.worst_bound_ratio``, None before any accuracy record), the
  rolling SLO window state (one entry per (op, bucket) with the
  ``dlaf_serve_latency_window`` p50/p95/p99 gauge values, and the
  ``dlaf_slo_breach_total`` burn counters), and process rank, pid and
  uptime; in a process that holds a fleet router, a ``fleet`` entry: one
  ``Router.fleet_view()`` per live router (membership, unresolved
  tickets, redispatch/handback/lost counts and the workers' breakers,
  local and non-blocking: a wedged worker never wedges ``/healthz``). A
  payload build failure answers 500 AND trips the flight recorder
  (``healthz_failure``).

Queues and routers register themselves at construction (weakrefs: a
dropped one disappears from ``/healthz``).
``obs.configure`` owns the lifecycle: a port change restarts the server;
``obs._shutdown`` (atexit) and ``_reset_for_tests`` stop it.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref
from typing import Optional

from ._state import STATE, current_rank

_server = None
_thread = None
_started_at: Optional[float] = None

#: weakrefs to live serve queues (see module docstring).
_QUEUES: list = []
_QUEUES_LOCK = threading.Lock()

#: weakrefs to live fleet routers (see module docstring).
_FLEETS: list = []


def register_queue(queue) -> None:
    """Expose ``queue`` on ``/healthz`` for its lifetime (a weakref;
    ``serve.Queue.__init__`` calls it, cheap enough to do always)."""
    with _QUEUES_LOCK:
        _QUEUES[:] = [r for r in _QUEUES if r() is not None]
        _QUEUES.append(weakref.ref(queue))


def live_queues() -> list:
    with _QUEUES_LOCK:
        alive = [(r, r()) for r in _QUEUES]
        _QUEUES[:] = [r for r, q in alive if q is not None]
        return [q for _, q in alive if q is not None]


def register_fleet(router) -> None:
    """Expose a fleet ``Router`` on ``/healthz`` for its lifetime (a
    weakref; ``fleet.Router.__init__`` calls it)."""
    with _QUEUES_LOCK:
        _FLEETS[:] = [r for r in _FLEETS if r() is not None]
        _FLEETS.append(weakref.ref(router))


def live_fleets() -> list:
    with _QUEUES_LOCK:
        alive = [(r, r()) for r in _FLEETS]
        _FLEETS[:] = [r for r, f in alive if f is not None]
        return [f for _, f in alive if f is not None]


#: Content types the endpoint answers with (negotiated per request).
OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; " \
                    "charset=utf-8"
CLASSIC_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def metrics_text(openmetrics: bool = False) -> str:
    """The /metrics body: live registry. ``openmetrics=True`` renders
    exemplars and the ``# EOF`` terminator (module docstring — only the
    OpenMetrics grammar HAS an exemplar clause; classic 0.0.4 scrapers
    choke on one)."""
    from .metrics import prometheus_text

    reg = STATE.registry
    if reg is None:
        return "# EOF\n" if openmetrics else ""
    text = prometheus_text(reg.snapshot(), exemplars=openmetrics)
    return text + "# EOF\n" if openmetrics else text


def healthz_payload() -> dict:
    """The /healthz JSON (module docstring). JSON-safe by construction:
    every non-finite number is mapped to None — a NaN must not produce
    the invalid-JSON token that breaks every scraper parsing it."""
    from ..health import circuit
    from .slo import QUANTILES, WINDOW_GAUGE, BREACH_COUNTER

    def safe(v):
        return float(v) if isinstance(v, (int, float)) \
            and not isinstance(v, bool) and math.isfinite(v) else None

    worst = None
    slo_rows: dict = {}
    breaches: dict = {}
    reg = STATE.registry
    if reg is not None:
        # the gauge's q label spellings (slo.QUANTILES) -> payload keys
        q_keys = {label: "p" + str(round(float(label) * 100))
                  for _, label in QUANTILES}
        for m in reg.snapshot():
            name = m.get("name")
            labels = m.get("labels") or {}
            if name == "dlaf_accuracy_ratio":
                v = safe(m.get("value"))
                if v is not None and (worst is None or v > worst):
                    worst = v
            elif name == WINDOW_GAUGE and labels.get("q") in q_keys:
                key = (labels.get("op", ""), labels.get("bucket", ""))
                cell = slo_rows.setdefault(
                    key, {"op": key[0], "bucket": key[1]})
                cell[q_keys[labels["q"]]] = safe(m.get("value"))
            elif name == BREACH_COUNTER:
                breaches[labels.get("op", "")] = safe(m.get("value"))
    payload = {
        "status": "ok",
        "rank": current_rank(),
        "pid": os.getpid(),
        "uptime_s": (time.monotonic() - _started_at
                     if _started_at is not None else 0.0),
        "queues": [q.stats() for q in live_queues()],
        "breakers": circuit.states(),
        "accuracy": {"worst_bound_ratio": worst},
        "slo": {"windows": [slo_rows[k] for k in sorted(slo_rows)],
                "breaches": breaches},
    }
    fleets = [f.fleet_view() for f in live_fleets()]
    if fleets:
        payload["fleet"] = fleets
    return payload


def _make_handler():
    # http.server imported here, not at module top: the exporter module
    # is imported unconditionally by serve.Queue for registration, and
    # the un-armed path must stay import-light
    from http.server import BaseHTTPRequestHandler

    from . import flight

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            try:
                if path == "/metrics":
                    om = "application/openmetrics-text" in \
                        (self.headers.get("Accept") or "")
                    body = metrics_text(openmetrics=om).encode()
                    ctype = OPENMETRICS_CTYPE if om else CLASSIC_CTYPE
                elif path == "/healthz":
                    body = json.dumps(healthz_payload()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown path "
                                    "(serving /metrics and /healthz)")
                    return
            except Exception as e:
                # a broken health endpoint IS an incident: capture the
                # ring before answering 500
                flight.trigger("healthz_failure", path=path,
                               error=type(e).__name__)
                self.send_error(500, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            # per-scrape stderr chatter routed to the leveled logger
            # instead of BaseHTTPRequestHandler's unconditional stderr
            from .logging import get_logger

            get_logger("obs.exporter").debug(fmt % args)

    return Handler


def start(port: int) -> int:
    """Start the daemon exporter on 127.0.0.1:``port`` (0 = OS-assigned,
    for tests); returns the BOUND port. Idempotent per running server —
    call :func:`stop` first to rebind."""
    global _server, _thread, _started_at
    if _server is not None:
        return _server.server_address[1]
    from http.server import ThreadingHTTPServer

    _server = ThreadingHTTPServer(("127.0.0.1", int(port)), _make_handler())
    _server.daemon_threads = True
    _started_at = time.monotonic()
    _thread = threading.Thread(target=_server.serve_forever,
                               name="dlaf-metrics-exporter", daemon=True)
    _thread.start()
    return _server.server_address[1]


def port() -> int:
    """The running exporter's bound port (0 = not running)."""
    return _server.server_address[1] if _server is not None else 0


def stop() -> None:
    """Shut the server down and join its thread (clean shutdown is part
    of the sink lifecycle: obs._shutdown calls this at exit)."""
    global _server, _thread, _started_at
    if _server is None:
        return
    _server.shutdown()
    _server.server_close()
    if _thread is not None:
        _thread.join(timeout=5.0)
    _server = _thread = None
    _started_at = None
