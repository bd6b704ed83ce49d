"""Event sinks and the JSONL artifact schema.

Port of ``dlaf_tpu/obs/sinks.py``, cut to the record types this port
emits. Two output formats:

* **JSON lines** (:class:`JsonlSink`): one self-describing event object per
  line, append-only. Everything the tracer, the metrics and the logger
  emit flows through here when ``DLAF_METRICS_PATH`` is set.
* **Prometheus text exposition** (:func:`.metrics.prometheus_text`, over a
  registry snapshot), for scraping.

Schema (version 1, the reference's). Every record carries ``v`` (int
schema version), ``type`` (str) and ``ts`` (float, unix seconds). Per
type:

``span``
    ``name`` str, ``dur_s`` finite float >= 0, ``depth`` int >= 0,
    ``parent`` str or null, ``attrs`` object. Optional ``flops`` (finite
    number) and ``gflops`` (finite number, derived = flops / dur_s / 1e9).
    Optional ``fenced: false`` marks spans whose wall clock is host
    dispatch only (asynchronous CUDA work, no device fence inside the
    region); such records never carry ``gflops``.
``metrics``
    ``metrics``: list of snapshot entries: ``name`` str, ``kind``
    "counter" | "gauge" | "histogram", ``labels`` object; counters and
    gauges carry a finite ``value``; histograms ``count``/``sum``/``min``/
    ``max`` and ``buckets`` (list of [le, count]).
``log``
    ``level`` str, ``logger`` str, ``msg`` str, ``fields`` object.
``resilience``
    ``site`` str, ``event`` one of :data:`RESILIENCE_EVENTS`, ``attrs``
    object; ``retry``/``give_up``/``deadline`` events carry a
    non-negative int ``attempt`` and ``retry`` a finite ``delay_s >= 0``.
``serve``
    ``dispatch``: one batched bucket dispatch (``op`` str, ``bucket_n`` int
    >= 1, ``nrhs`` int >= 0, ``dtype`` str, ``lanes`` int in [0, batch],
    ``batch`` int >= 1, ``cache`` "hit" | "miss", finite ``dispatch_s``
    >= 0, optional ``stages`` object of finite walls); ``request``: one
    served request (``op`` str, ``n`` int >= 1, ``bucket_n`` >= n,
    ``dtype`` str, finite ``queue_s``/``total_s`` >= 0, ``attrs``).
``flight_trigger``
    Header of a flight-recorder dump: ``reason`` one of
    :data:`FLIGHT_REASONS`, ``dump_seq`` int >= 1, ``records`` int >= 0,
    ``attrs`` object. It appears only in the standalone
    ``<metrics_path>.flight.jsonl`` incident artifact.

Every record may carry ``rank`` (int >= 0, the process rank once known:
``DLAF_METRICS_PATH`` accepts a ``%r`` per-rank template so ranks never
interleave one file) and the trace correlation of :mod:`.context`:
``trace_id`` (non-empty str, or non-empty list of non-empty strs for a
batch) and ``span_id`` (non-empty str).

:func:`validate_records` is the schema owner behind the tests and
``python -m dlaf_tpu_torch.obs.validate``; its ``require_*`` flags are the
reference's for the records above: spans, gflops, collectives, retries,
comm-overlap, serve, resilience and flight. ``require_serve`` drops the
reference's leg of a per-request ``accuracy`` record, whose emitter
(``obs/accuracy.py``) is not ported yet. The validators of the
``program``, ``accuracy``, ``devtrace``, ``critpath``/``whatif``/
``schedule``, ``autotune`` and ``fleet`` records, and the history lines,
come with the modules that emit them.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

SCHEMA_VERSION = 1

#: The record types this port writes.
KNOWN_TYPES = ("span", "metrics", "log", "serve", "resilience", "flight_trigger")

#: The resilience record's event vocabulary (schema above).
RESILIENCE_EVENTS = ("retry", "give_up", "deadline", "circuit_open",
                     "circuit_half_open", "circuit_close", "shed",
                     "expired", "checkpoint", "preempt", "resume",
                     "drain")

#: The flight recorder's trigger vocabulary: the reference's whole list
#: (the port's trigger sites are listed in :mod:`.flight`).
FLIGHT_REASONS = ("breaker_open", "overload_shed",
                  "factorization_exhausted", "accuracy_breach",
                  "healthz_failure", "slo_breach_burst",
                  "autotune_exhausted", "fleet_worker_down")

def expand_rank_template(path: str) -> str:
    """Resolve a ``%r`` per-rank placeholder in a metrics path, but ONLY
    when the rank is already known (:func:`._state.current_rank`). Before
    a process group exists the template is returned unexpanded; the sink
    expands it at first write, and ``initialize_multihost`` reconfigures
    with the rank once its world is up."""
    if "%r" not in path:
        return path
    from ._state import current_rank

    rank = current_rank()
    return path if rank is None else path.replace("%r", str(rank))


class JsonlSink:
    """Append-only JSON-lines writer; thread-safe, line-buffered so a
    killed process still leaves a readable prefix."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = None

    def write(self, record: dict) -> None:
        record.setdefault("v", SCHEMA_VERSION)
        record.setdefault("ts", time.time())
        if "rank" not in record:
            # stamp the process rank once known
            from ._state import current_rank

            rank = current_rank()
            if rank is not None:
                record["rank"] = rank
        # request-scoped trace correlation: the active
        # obs.trace_context's trace_id/span_id land on EVERY record type
        # written under it — one ContextVar read when no context is live
        from .context import record_stamp

        record_stamp(record)
        from ._state import STATE

        if STATE.flight is not None:
            # flight ring capture, pre-serialization and pre-file-write:
            # the moments before an incident survive a lost sink file
            STATE.flight.capture(record)
        line = json.dumps(record, default=str)
        with self._lock:
            if self._f is None:
                if "%r" in self.path:
                    # deferred %r template: expand now, and record the
                    # resolved path so a later configure() with the rank
                    # reopens cleanly. If the rank is STILL unknown (writes
                    # before the process group exists), use a per-process
                    # placeholder: claiming rank 0 would make every such
                    # process append to rank 0's file
                    from ._state import current_rank

                    rank = current_rank()
                    self.path = self.path.replace(
                        "%r", str(rank) if rank is not None
                        else f"u{os.getpid()}")
                self._f = open(self.path, "a", buffering=1)
            self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def _validate_span(r: dict, where: str, errors: list) -> None:
    if not isinstance(r.get("name"), str) or not r.get("name"):
        errors.append(f"{where}: span without a name")
    if not _finite(r.get("dur_s")) or r.get("dur_s", -1) < 0:
        errors.append(f"{where}: span dur_s missing/non-finite/negative")
    if not isinstance(r.get("depth"), int) or r.get("depth", -1) < 0:
        errors.append(f"{where}: span depth missing or negative")
    if not isinstance(r.get("attrs", {}), dict):
        errors.append(f"{where}: span attrs must be an object")
    for key in ("flops", "gflops"):
        if key in r and not _finite(r[key]):
            errors.append(f"{where}: span {key} non-finite")
    if r.get("fenced") is False and "gflops" in r:
        # the tracer never derives throughput from unfenced dispatch
        # wall; hold third-party emitters to the same contract
        errors.append(f"{where}: unfenced span must not carry gflops")
    if r.get("name") == "robust_cholesky.attempt":
        # retry spans are the recovery audit trail:
        # each must say WHICH attempt with WHAT shift, or the artifact
        # cannot reconstruct the recovery history
        attrs = r.get("attrs") or {}
        for key in ("attempt", "shift"):
            if not _finite(attrs.get(key)):
                errors.append(
                    f"{where}: retry span missing finite attr {key!r}")


def _validate_serve(r: dict, where: str, errors: list) -> None:
    event = r.get("event")
    if event not in ("dispatch", "request"):
        errors.append(f"{where}: serve event must be dispatch|request, "
                      f"got {event!r}")
        return
    for key in ("op", "dtype"):
        if not isinstance(r.get(key), str) or not r.get(key):
            errors.append(f"{where}: serve record without a {key}")
    if not isinstance(r.get("bucket_n"), int) \
            or isinstance(r.get("bucket_n"), bool) or r.get("bucket_n", 0) < 1:
        errors.append(f"{where}: serve bucket_n must be a positive int")
    if event == "dispatch":
        lanes, batch = r.get("lanes"), r.get("batch")
        if not isinstance(r.get("nrhs"), int) \
                or isinstance(r.get("nrhs"), bool) or r.get("nrhs", -1) < 0:
            errors.append(f"{where}: serve dispatch nrhs must be a "
                          "non-negative int")
        if not isinstance(batch, int) or isinstance(batch, bool) or batch < 1:
            errors.append(f"{where}: serve dispatch batch must be a "
                          "positive int")
        if not isinstance(lanes, int) or isinstance(lanes, bool) \
                or lanes < 0 or (isinstance(batch, int) and lanes > batch):
            errors.append(f"{where}: serve dispatch lanes must be an int "
                          "in [0, batch]")
        if r.get("cache") not in ("hit", "miss"):
            errors.append(f"{where}: serve dispatch cache must be "
                          f"hit|miss, got {r.get('cache')!r}")
        if not _finite(r.get("dispatch_s")) or r.get("dispatch_s", -1) < 0:
            errors.append(f"{where}: serve dispatch_s "
                          "missing/non-finite/negative")
        stages = r.get("stages")
        if stages is not None:
            if not isinstance(stages, dict):
                errors.append(f"{where}: serve dispatch stages must be an "
                              "object")
            else:
                for key, v in stages.items():
                    if not _finite(v) or v < 0:
                        errors.append(f"{where}: serve dispatch stages"
                                      f"[{key!r}] non-finite/negative")
    else:
        if not isinstance(r.get("n"), int) or isinstance(r.get("n"), bool) \
                or r.get("n", 0) < 1:
            errors.append(f"{where}: serve request n must be a positive int")
        elif isinstance(r.get("bucket_n"), int) \
                and r["bucket_n"] < r["n"]:
            errors.append(f"{where}: serve request bucket_n < n — the "
                          "bucket must be a ceiling")
        for key in ("queue_s", "total_s"):
            if not _finite(r.get(key)) or r.get(key, -1) < 0:
                errors.append(f"{where}: serve request {key} "
                              "missing/non-finite/negative")
    if not isinstance(r.get("attrs", {}), dict):
        errors.append(f"{where}: serve attrs must be an object")


def _validate_resilience(r: dict, where: str, errors: list) -> None:
    if not isinstance(r.get("site"), str) or not r.get("site"):
        errors.append(f"{where}: resilience record without a site")
    event = r.get("event")
    if event not in RESILIENCE_EVENTS:
        errors.append(f"{where}: resilience event must be one of "
                      f"{RESILIENCE_EVENTS}, got {event!r}")
    if event in ("retry", "give_up", "deadline"):
        attempt = r.get("attempt")
        if not isinstance(attempt, int) or isinstance(attempt, bool) \
                or attempt < 0:
            errors.append(f"{where}: resilience {event} record needs a "
                          "non-negative int attempt")
    if event == "retry" and (not _finite(r.get("delay_s"))
                             or r.get("delay_s", -1) < 0):
        errors.append(f"{where}: resilience retry record needs finite "
                      "delay_s >= 0 (the backoff actually applied)")
    if not isinstance(r.get("attrs", {}), dict):
        errors.append(f"{where}: resilience attrs must be an object")


def _validate_flight_trigger(r: dict, where: str, errors: list) -> None:
    if r.get("reason") not in FLIGHT_REASONS:
        errors.append(f"{where}: flight_trigger reason must be one of "
                      f"{FLIGHT_REASONS}, got {r.get('reason')!r}")
    for key in ("dump_seq", "records"):
        if not isinstance(r.get(key), int) or isinstance(r.get(key), bool) \
                or r.get(key, -1) < 0:
            errors.append(f"{where}: flight_trigger {key} must be a "
                          "non-negative int")
    if not isinstance(r.get("attrs", {}), dict):
        errors.append(f"{where}: flight_trigger attrs must be an object")


def _validate_trace_stamp(r: dict, where: str, errors: list) -> None:
    """Optional trace correlation fields, any record type: ``trace_id``
    a non-empty str (request scope) or non-empty list of non-empty strs
    (batch scope); ``span_id`` a non-empty str."""
    tid = r.get("trace_id")
    if tid is not None:
        if isinstance(tid, str):
            if not tid:
                errors.append(f"{where}: trace_id must be non-empty")
        elif isinstance(tid, list):
            if not tid or any(not isinstance(t, str) or not t for t in tid):
                errors.append(f"{where}: trace_id list must be non-empty "
                              "with non-empty string members")
        else:
            errors.append(f"{where}: trace_id must be a string or a list "
                          f"of strings, got {type(tid).__name__}")
    sid = r.get("span_id")
    if sid is not None and (not isinstance(sid, str) or not sid):
        errors.append(f"{where}: span_id must be a non-empty string")


def _validate_metrics(r: dict, where: str, errors: list) -> None:
    entries = r.get("metrics")
    if not isinstance(entries, list):
        errors.append(f"{where}: metrics record without a metrics list")
        return
    for i, m in enumerate(entries):
        w = f"{where} metric[{i}]"
        if not isinstance(m.get("name"), str) or not m.get("name"):
            errors.append(f"{w}: missing name")
        kind = m.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            errors.append(f"{w}: bad kind {kind!r}")
        elif kind == "histogram":
            for key in ("count", "sum"):
                if not _finite(m.get(key)):
                    errors.append(f"{w}: histogram {key} non-finite")
        elif not _finite(m.get("value")):
            errors.append(f"{w}: {kind} value non-finite")
        if not isinstance(m.get("labels", {}), dict):
            errors.append(f"{w}: labels must be an object")


def validate_records(records, require_spans=False, require_gflops=False,
                     require_collectives=False, require_retries=False,
                     require_comm_overlap=False, require_serve=False,
                     require_resilience=False, require_flight=False,
                     require_fallbacks=False) -> list:
    """Validate parsed records; returns a list of error strings (empty =
    valid). The ``require_*`` obligations, as the reference's:

    * ``require_spans``: >= 1 span record; ``require_gflops``: >= 1 span
      with finite derived gflops;
    * ``require_collectives``: a positive
      ``dlaf_comm_collective_bytes_total`` counter in a metrics snapshot;
    * ``require_retries``: >= 1 ``robust_cholesky.attempt`` span with
      attempt >= 1 (a shifted re-attempt);
    * ``require_comm_overlap``: positive ``dlaf_comm_overlapped_total
      {algo,axis}`` counters and per-axis
      ``dlaf_comm_collective_bytes_total`` for BOTH grid axes;
    * ``require_serve``: a warmed steady-state stream: >= 1 dispatch with
      >= 2 lanes and a cache hit, NO cache-miss dispatch, >= 1 request
      with finite latency (the reference's per-request accuracy leg waits
      for ``obs/accuracy.py``);
    * ``require_resilience``: >= 1 ``resilience`` record of event retry or
      resume, and NO ``dlaf_circuit_state`` gauge left open (2) in the
      last snapshot;
    * ``require_flight``: >= 1 ``flight_trigger`` record with a known
      reason and >= 1 ordinary record captured by the ring;
    * ``require_fallbacks``: a positive ``dlaf_fallback_total`` counter in
      a metrics snapshot (a degradation drill's audit trail)."""
    errors = []
    n_spans = n_gflops = n_coll = n_retries = n_fallbacks = 0
    n_serve_batched = n_serve_miss = n_serve_requests = 0
    n_resilience_proof = 0
    n_flight_triggers = n_flight_context = 0
    circuit_state = {}                # site -> latest gauge value seen
    overlap_axes, byte_axes = set(), set()
    for i, r in enumerate(records):
        where = f"record {i}"
        if not isinstance(r, dict):
            errors.append(f"{where}: not an object")
            continue
        rtype = r.get("type")
        if rtype not in KNOWN_TYPES:
            errors.append(f"{where}: unknown type {rtype!r}")
            continue
        if not _finite(r.get("ts")):
            errors.append(f"{where}: missing/non-finite ts")
        if r.get("v") != SCHEMA_VERSION:
            errors.append(f"{where}: schema version {r.get('v')!r} != "
                          f"{SCHEMA_VERSION}")
        if "rank" in r and (not isinstance(r["rank"], int)
                            or isinstance(r["rank"], bool)
                            or r["rank"] < 0):
            errors.append(f"{where}: rank must be a non-negative int, "
                          f"got {r['rank']!r}")
        _validate_trace_stamp(r, where, errors)
        if rtype == "flight_trigger":
            _validate_flight_trigger(r, where, errors)
            if r.get("reason") in FLIGHT_REASONS:
                n_flight_triggers += 1
            continue
        n_flight_context += 1
        if rtype == "resilience":
            _validate_resilience(r, where, errors)
            if r.get("event") in ("retry", "resume"):
                n_resilience_proof += 1
        elif rtype == "serve":
            _validate_serve(r, where, errors)
            if r.get("event") == "dispatch":
                if isinstance(r.get("lanes"), int) and r["lanes"] >= 2 \
                        and r.get("cache") == "hit":
                    n_serve_batched += 1
                if r.get("cache") == "miss":
                    n_serve_miss += 1
            elif r.get("event") == "request" \
                    and _finite(r.get("total_s")):
                n_serve_requests += 1
        elif rtype == "span":
            _validate_span(r, where, errors)
            n_spans += 1
            if _finite(r.get("gflops")):
                n_gflops += 1
            if r.get("name") == "robust_cholesky.attempt" and \
                    (r.get("attrs") or {}).get("attempt", 0) >= 1:
                # attempt 0 is the plain factorization; only a shifted
                # RE-attempt proves the recovery path ran
                n_retries += 1
        elif rtype == "metrics":
            _validate_metrics(r, where, errors)
            for m in r.get("metrics") or []:
                if not isinstance(m, dict) or not _finite(m.get("value")):
                    continue
                labels = m.get("labels") or {}
                if m.get("name") == "dlaf_comm_collective_bytes_total" \
                        and m["value"] > 0:
                    n_coll += 1
                    if labels.get("axis"):
                        byte_axes.add(labels["axis"])
                if m.get("name") == "dlaf_comm_overlapped_total" \
                        and m["value"] > 0 and labels.get("algo") \
                        and labels.get("axis"):
                    overlap_axes.add(labels["axis"])
                if m.get("name") == "dlaf_fallback_total" and m["value"] > 0:
                    n_fallbacks += 1
                if m.get("name") == "dlaf_circuit_state":
                    # records are ordered, so this ends at the LAST
                    # snapshot's value per site
                    circuit_state[labels.get("site", "")] = float(m["value"])
        elif rtype == "log":
            if not isinstance(r.get("msg"), str):
                errors.append(f"{where}: log without msg")
    if require_spans and n_spans == 0:
        errors.append("artifact contains no span records")
    if require_gflops and n_gflops == 0:
        errors.append("artifact contains no span with finite derived gflops")
    if require_collectives and n_coll == 0:
        errors.append("artifact contains no positive "
                      "dlaf_comm_collective_bytes_total counter")
    if require_retries and n_retries == 0:
        errors.append("artifact contains no robust_cholesky.attempt "
                      "retry span (attempt >= 1)")
    if require_fallbacks and n_fallbacks == 0:
        errors.append("artifact contains no positive dlaf_fallback_total "
                      "counter")
    if require_serve:
        if n_serve_batched == 0:
            errors.append("artifact contains no batched serve dispatch "
                          "(dispatch record with lanes >= 2, cache hit)")
        if n_serve_miss > 0:
            errors.append(f"artifact contains {n_serve_miss} serve "
                          "dispatch(es) with cache miss — a warmed "
                          "steady-state stream must be all hits")
        if n_serve_requests == 0:
            errors.append("artifact contains no serve request record with "
                          "finite latency")
    if require_resilience:
        if n_resilience_proof == 0:
            errors.append("artifact contains no resilience retry/resume "
                          "record (recovery never exercised)")
        open_sites = sorted(s for s, v in circuit_state.items() if v >= 2)
        if open_sites:
            errors.append("circuit breaker(s) left open at artifact end "
                          f"(dlaf_circuit_state >= 2): {open_sites}")
    if require_flight:
        if n_flight_triggers == 0:
            errors.append("artifact contains no flight_trigger record "
                          "with a known reason (no incident dump)")
        if n_flight_context == 0:
            errors.append("flight artifact carries no pre-trigger context "
                          "records (the ring captured nothing)")
    if require_comm_overlap:
        if not {"row", "col"} <= overlap_axes:
            errors.append("artifact lacks positive finite "
                          "dlaf_comm_overlapped_total{algo,axis} counters "
                          f"for both grid axes (got {sorted(overlap_axes)})")
        if not {"row", "col"} <= byte_axes:
            errors.append("artifact lacks finite per-axis "
                          "dlaf_comm_collective_bytes_total for both grid "
                          f"axes (got {sorted(byte_axes)})")
    return errors


def read_records(path: str) -> list:
    """Parse a JSONL artifact; raises ValueError on an unparsable line."""
    records = []
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                records.append(json.loads(raw))
            except ValueError as e:
                raise ValueError(f"{path}:{ln}: unparsable JSON ({e})")
    return records


def validate_file(path: str, **require) -> list:
    """Errors for the artifact at ``path`` (empty list = schema-valid)."""
    try:
        records = read_records(path)
    except (OSError, ValueError) as e:
        return [str(e)]
    return validate_records(records, **require)
