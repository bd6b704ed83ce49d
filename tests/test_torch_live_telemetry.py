"""The port's live telemetry (``dlaf_tpu_torch/obs``: slo, flight, exporter,
the trace context) and its records in the serving and resilience layers,
on the CPU: the reference's cases (``tests/test_live_telemetry.py``)
re-run against the port.

* The SlidingWindow's expiry and bounded memory under a fake clock; the
  ``observe_latency`` path (windowed gauges in a fixed order, the breach
  counter against ``DLAF_SLO_P99_MS``, the breach-burst flight dump).
* Exemplar trace IDs on histogram buckets (request scope only) and their
  grammar; the trace context stamped onto every record type, nested.
* A serve stream through ``serve.Queue``: one trace ID joins a request's
  records, the dispatch's span ID joins request and dispatch; a retried
  dispatch's records carry the batch's IDs.
* The ``/metrics`` + ``/healthz`` exporter on port 0 (two scrapes whose
  counters do not decrease, ``Queue.stats()`` round-tripped, the SLO
  windows, 404, the lifecycle, a 500 that trips the flight recorder);
  the thread is joined after every test.
* The flight recorder: the ring, the atomic dump, the cooldown per
  reason, each trigger site of the port (breaker open, overload shed,
  factorization exhausted) and the clean run that dumps nothing.
* The serve stream's and a ``robust_cholesky`` retry's artifacts pass the
  port's validator and the reference's under ``--require-serve``,
  ``--require-resilience`` and ``--require-retries``. Under
  ``DLAF_ACCURACY=1`` the stream carries the per-request accuracy records
  that the reference's ``--require-serve`` also wants, so both pass it.
"""

import gc
import json
import math
import os
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu_torch import config, health, obs
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.health import circuit
from dlaf_tpu_torch.health.policy import with_policy
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.obs import exporter, flight, slo
from dlaf_tpu_torch.obs._state import STATE
from dlaf_tpu_torch.obs.context import current_trace, trace_matches
from dlaf_tpu_torch.obs.metrics import SlidingWindow, prometheus_text, quantile
from dlaf_tpu_torch.serve.programs import ProgramService
from dlaf_tpu_torch.serve.queue import Queue, Request

ENV = ("DLAF_METRICS_PATH", "DLAF_METRICS_PORT", "DLAF_FLIGHT_RECORDER", "DLAF_SLO_P99_MS",
       "DLAF_SLO_WINDOW_S", "DLAF_SLO_BURST", "DLAF_LOG")

OPENMETRICS_ACCEPT = "application/openmetrics-text; version=1.0.0"


@pytest.fixture(autouse=True)
def live_reset(monkeypatch):
    """Every test leaves no metrics, no exporter thread (joined) and no
    breakers behind."""
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    obs._reset_for_tests()
    config.initialize()
    yield
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    obs._reset_for_tests()
    assert exporter.port() == 0
    circuit.reset()
    config.initialize()


def metrics_on(tmp_path, **cfg):
    path = str(tmp_path / "live.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off", **cfg))
    return path


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _hpd(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


def _queue(**kw):
    kw = {"buckets": (16,), "batch": 2, "deadline_s": 1e9, **kw}
    return Queue(ProgramService(device="cpu"), **kw)


def _serve_stream(n_reqs=4, batch=2, n=12, seed=0):
    """A warm queue and a stream of completed Cholesky tickets."""
    q = _queue(batch=batch)
    q.warmup([Request(op="cholesky", a=_hpd(n, seed))])
    tickets = [q.submit(Request(op="cholesky", a=_hpd(n, seed + i))) for i in range(n_reqs)]
    q.flush()
    for t in tickets:
        t.result()
    return q, tickets


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, route, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}")
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read().decode()


def _counters(text):
    out = {}
    for ln in text.splitlines():
        if ln.startswith("#") or " " not in ln:
            continue
        name, val = ln.rsplit(" ", 1)
        if "_total" in name or "_count" in name:
            out[name] = float(val)
    return out


# ---------------------------------------------------------------------------
# windows and the SLO path
# ---------------------------------------------------------------------------

def test_sliding_window_expiry_bounds_and_singleton():
    clock = FakeClock()
    w = SlidingWindow(window_s=6.0, epochs=3, clock=clock)
    w.observe(1.0)
    clock.t = 1.0
    w.observe(2.0)
    clock.t = 2.5
    w.observe(3.0)
    assert sorted(w.samples()) == [1.0, 2.0, 3.0]
    clock.t = 6.1
    assert sorted(w.samples()) == [3.0]
    clock.t = 100.0
    assert w.samples() == [] and math.isnan(w.quantile(0.5))
    small = SlidingWindow(window_s=10.0, epochs=2, cap=4, clock=FakeClock())
    for i in range(10):
        small.observe(float(i))
    assert small.count() == 4 and small.dropped == 6
    with pytest.raises(ValueError):
        SlidingWindow(window_s=0.0)
    h = obs.Registry().histogram("lat", op="x")
    win = h.windowed(window_s=60.0, clock=FakeClock())
    assert h.windowed(window_s=999.0) is win
    h.observe(0.25)
    h.observe(0.5)
    assert sorted(win.samples()) == [0.25, 0.5]


@pytest.mark.parametrize("objective", [0.0, 100.0])
def test_observe_latency_gauges_and_breach_counter(tmp_path, objective):
    metrics_on(tmp_path, slo_p99_ms=objective)
    lat = [0.01, 0.02, 0.05, 0.2, 0.3]          # 2 of 5 over 100 ms
    for v in lat:
        obs.observe_latency("serve.cholesky", v, bucket="64")
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m
            for m in obs.registry().snapshot()}
    breach = snap.get(("dlaf_slo_breach_total", (("op", "serve.cholesky"),)))
    assert (breach["value"] if breach else 0) == (2 if objective else 0)
    for q in ("0.5", "0.95", "0.99"):
        g = snap[("dlaf_serve_latency_window",
                  (("bucket", "64"), ("op", "serve.cholesky"), ("q", q)))]
        assert g["value"] == quantile(lat, float(q))
    assert snap[("dlaf_serve_latency_seconds",
                 (("bucket", "64"), ("op", "serve.cholesky")))]["count"] == 5
    text = obs.prometheus_snapshot_text()
    assert re.findall(r'dlaf_serve_latency_window\{[^}]*q="([^"]+)"\}', text) == \
        ["0.5", "0.95", "0.99"]
    assert obs.prometheus_snapshot_text() == text


def test_with_policy_success_feeds_window_and_retries_count(tmp_path):
    path = metrics_on(tmp_path)
    assert with_policy("mysite", lambda: 41) == 41
    fails = []

    def flaky():
        fails.append(1)
        if len(fails) < 3:
            raise RuntimeError("transient")
        return 7

    assert with_policy("flaky", flaky, policy=health.RetryPolicy(max_attempts=3)) == 7
    snap = obs.registry().snapshot()
    assert len([m for m in snap if m["name"] == "dlaf_serve_latency_window"
                and m["labels"]["op"] == "mysite"]) == 3
    assert obs.registry().counter("dlaf_retry_total", site="flaky").value == 2
    retries = [r for r in obs.read_records(path) if r["type"] == "resilience"]
    assert [(r["event"], r["attempt"]) for r in retries] == [("retry", 0), ("retry", 1)]


# ---------------------------------------------------------------------------
# exemplars and the trace context
# ---------------------------------------------------------------------------

def test_exemplars_request_scope_and_grammar(tmp_path):
    metrics_on(tmp_path)
    h = obs.histogram("lat", op="x")
    with obs.trace_context(trace_id="aabbccdd00112233"):
        h.observe(0.1)
    with obs.trace_context(trace_id=["t1", "t2"], span_id="s1"):
        h.observe(0.2)             # batch scope: never an exemplar
    h.observe(0.3)
    snap = [m for m in obs.registry().snapshot() if m["name"] == "lat"][0]
    assert {tid for tid, _ in snap["exemplars"].values()} == {"aabbccdd00112233"}
    text = prometheus_text(obs.registry().snapshot(), exemplars=True)
    lines = [ln for ln in text.splitlines() if " # {" in ln]
    gram = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*_bucket\{[^}]*le="[^"]+"[^}]*\} '
                      r'\d+ # \{trace_id="[0-9a-f]{1,32}"\} [0-9.eE+-]+$')
    assert lines and all(gram.match(ln) for ln in lines)
    assert " # {" not in obs.prometheus_snapshot_text()


def test_trace_context_stamps_every_record_type_and_nests(tmp_path):
    path = metrics_on(tmp_path)
    with obs.trace_context(trace_id="deadbeef00000001", span_id="span01"):
        obs.emit_event("resilience", site="s", event="retry", attempt=0, delay_s=0.0,
                       attrs={})
        with obs.span("work"):
            pass
        obs.emit_event("log", level="info", logger="t", msg="m", fields={})
    obs.emit_event("resilience", site="s", event="retry", attempt=0, delay_s=0.0, attrs={})
    obs.flush()
    records = obs.read_records(path)
    inside = [r for r in records if "trace_id" in r]
    assert {r["type"] for r in inside} == {"resilience", "span", "log"}
    assert all(r["trace_id"] == "deadbeef00000001" and r["span_id"] == "span01"
               for r in inside)
    assert [r for r in records if r["type"] == "resilience" and "trace_id" not in r]
    assert not obs.validate_records(records) and not jsinks.validate_records(records)
    assert current_trace() == (None, None)
    with obs.trace_context(trace_id=["a", "b"], span_id="s1"):
        assert current_trace() == (("a", "b"), "s1")
        with obs.trace_context(trace_id="a"):
            assert current_trace() == ("a", "s1")
    assert trace_matches({"trace_id": ["a", "b"]}, "b") and not trace_matches({}, "a")


# ---------------------------------------------------------------------------
# the serve queue's records
# ---------------------------------------------------------------------------

def test_serve_trace_join_end_to_end(tmp_path):
    """One trace ID appears on the request's serve record, its span record
    and (by membership) the dispatch record; the span ID joins request and
    dispatch; with DLAF_ACCURACY=1 the artifact passes --require-serve in
    both validators, the reference's per-request accuracy leg included."""
    path = metrics_on(tmp_path, accuracy="1")
    q, tickets = _serve_stream(n_reqs=4, batch=2)
    obs.flush()
    records = obs.read_records(path)
    assert not obs.validate_records(records, require_serve=True)
    assert jsinks.validate_records(records, require_serve=True) == []
    acc = [r for r in records if r.get("type") == "accuracy"]
    assert len(acc) == 4 and {r["site"] for r in acc} == {"serve"}
    assert all(r["bound_ratio"] < 1.0 for r in acc)
    tid = tickets[0].trace_id
    mine = [r for r in records if trace_matches(r, tid)]
    assert {r["type"] for r in mine} >= {"serve", "span"}
    req = [r for r in mine if r.get("event") == "request"][0]
    disp = [r for r in mine if r.get("event") == "dispatch"][0]
    assert req["trace_id"] == tid and tid in disp["trace_id"]
    assert req["span_id"] == disp["span_id"]
    assert set(disp["stages"]) == {"compose_s", "program_s", "fetch_s", "unpad_s"}
    assert len({t.trace_id for t in tickets}) == 4
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m
            for m in obs.registry().snapshot()}
    assert snap[("dlaf_serve_requests_total", (("op", "cholesky"),))]["value"] == 4
    assert snap[("dlaf_serve_dispatch_total", (("op", "cholesky"),))]["value"] == 2
    assert snap[("dlaf_serve_cache_total", (("event", "warmup"), ("op", "cholesky")))][
        "value"] == 1
    assert [r["name"] for r in records if r["type"] == "span"].count("serve.warmup") == 1


def test_retried_dispatch_records_carry_the_batch_trace(tmp_path):
    """A dispatch that fails once and is retried: its resilience record
    carries the batch's member trace IDs; the artifact passes
    --require-resilience under both validators."""
    path = metrics_on(tmp_path)
    q = _queue(retry_attempts=2, retry_backoff_s=0.0)
    run = q.service.run
    failed = []

    def flaky(spec, *args):
        if not failed:
            failed.append(1)
            raise RuntimeError("injected dispatch failure")
        return run(spec, *args)

    q.service.run = flaky
    tickets = [q.submit(Request(op="cholesky", a=_hpd(12, i))) for i in range(2)]
    for t in tickets:
        t.result()
    obs.flush()
    records = obs.read_records(path)
    retry = [r for r in records if r["type"] == "resilience" and r["event"] == "retry"]
    assert len(retry) == 1 and sorted(retry[0]["trace_id"]) == \
        sorted(t.trace_id for t in tickets)
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(records, require_resilience=True) == []


def test_robust_cholesky_retry_artifact_passes_both_validators(tmp_path):
    """An indefinite matrix recovers after shifted retries: an attempt span
    each, a retry count and record each; --require-retries and
    --require-resilience hold under both validators."""
    path = metrics_on(tmp_path)
    a = _hpd(16)
    a[5, 5] = -1.0
    res = health.robust_cholesky("L", Matrix.from_global(a, TileElementSize(4, 4),
                                                         device="cpu"))
    assert res.attempts >= 2 and res.infos[0] > 0
    obs.flush()
    records = obs.read_records(path)
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(records, require_retries=True, require_resilience=True,
                        require_spans=True) == []
    attempts = [r for r in records if r["type"] == "span"
                and r["name"] == "robust_cholesky.attempt"]
    assert [r["attrs"]["attempt"] for r in attempts] == list(range(res.attempts))
    assert [r["attrs"]["info"] for r in attempts] == list(res.infos)
    assert [r["attrs"]["shift"] for r in attempts] == list(res.shifts)
    assert obs.registry().counter("dlaf_retry_total", algo="cholesky").value == \
        res.attempts - 1


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------

def test_metrics_scrape_monotone_and_healthz_roundtrip(tmp_path):
    metrics_on(tmp_path, slo_p99_ms=0.001)
    port = exporter.start(0)
    q, _ = _serve_stream(n_reqs=2, batch=2)
    _, scrape1 = _get(port, "/metrics")
    for i in range(2):
        q.submit(Request(op="cholesky", a=_hpd(12, 50 + i)))
    q.flush()
    _, scrape2 = _get(port, "/metrics")
    c1, c2 = _counters(scrape1), _counters(scrape2)
    assert c1 and set(c1) <= set(c2)
    assert all(c2[k] >= v for k, v in c1.items())
    assert c2['dlaf_serve_requests_total{op="cholesky"}'] == 4.0
    assert " # {" not in scrape2
    _, om = _get(port, "/metrics", accept=OPENMETRICS_ACCEPT)
    assert " # {trace_id=" in om and om.endswith("# EOF\n")
    gc.collect()      # no dead queue may leave the list between the two reads
    status, body = _get(port, "/healthz")
    payload = json.loads(body)
    assert status == 200 and payload["status"] == "ok"
    # every live queue of the process is listed (other tests' may still
    # be alive), each stats() round-tripped faithfully, this one among them
    live = exporter.live_queues()
    assert q in live
    assert payload["queues"] == [json.loads(json.dumps(x.stats())) for x in live]
    site, bucket = next(iter(q.stats()["buckets"].items()))
    assert bucket["breaker"] == "closed" and payload["breakers"][site] == "closed"
    assert payload["pid"] == os.getpid() and payload["uptime_s"] >= 0
    rows = {(w["op"], w["bucket"]): w for w in payload["slo"]["windows"]}
    gauges = {(m["labels"]["op"], m["labels"]["bucket"], m["labels"]["q"]): m["value"]
              for m in obs.registry().snapshot() if m["name"] == "dlaf_serve_latency_window"}
    assert rows and all(row[key] == gauges[(op, b, q)] for (op, b), row in rows.items()
                        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")))
    assert payload["slo"]["breaches"]["serve.cholesky"] == 4.0


def test_exporter_lifecycle_404_and_config_knob(tmp_path):
    assert exporter.port() == 0
    port = exporter.start(0)
    assert exporter.port() == port > 0
    assert _get(port, "/metrics")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/nope")
    assert ei.value.code == 404
    exporter.stop()
    assert exporter.port() == 0
    # the knob alone arms the registry (a scrape-only deployment)
    free = _free_port()
    config.initialize(config.Configuration(metrics_port=free, log="off"))
    assert exporter.port() == free and obs.metrics_active() and STATE.sink is None
    obs.counter("scrape_only_total").inc()
    assert "scrape_only_total 1" in _get(free, "/metrics")[1]
    config.initialize(config.Configuration(log="off"))
    assert exporter.port() == 0


def test_healthz_failure_trips_flight(tmp_path):
    path = metrics_on(tmp_path, flight_recorder=32)
    port = exporter.start(0)
    q, _ = _serve_stream(n_reqs=2, batch=2)
    q.stats = lambda: 1 / 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(port, "/healthz")
    assert ei.value.code == 500
    assert obs.read_records(path + ".flight.jsonl")[0]["reason"] == "healthz_failure"


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_dump_and_cooldown(tmp_path):
    clock = FakeClock()
    dump = str(tmp_path / "dump.flight.jsonl")
    rec = obs.FlightRecorder(capacity=5, path=dump, cooldown_s=60.0, clock=clock)
    for i in range(12):
        rec.capture({"v": 1, "type": "log", "ts": float(i), "level": "info", "logger": "t",
                     "msg": str(i), "i": i})
    assert rec.trigger("overload_shed", depth=9) == dump
    records = obs.read_records(dump)
    assert records[0]["reason"] == "overload_shed" and records[0]["records"] == 5
    assert records[0]["attrs"] == {"depth": 9}
    assert [r["i"] for r in records[1:]] == [7, 8, 9, 10, 11]
    assert not obs.validate_records(records, require_flight=True)
    assert not jsinks.validate_records(records, require_flight=True)
    clock.t = 10.0
    assert rec.trigger("overload_shed") is None
    assert rec.trigger("breaker_open") == dump and rec.dump_seq == 2
    clock.t = 70.1
    assert rec.trigger("overload_shed") == dump
    assert obs.read_records(dump)[0]["dump_seq"] == 3


def test_flight_unarmed_and_clean_runs_write_nothing(tmp_path):
    path = metrics_on(tmp_path)
    assert flight.trigger("breaker_open") is None
    config.initialize(config.Configuration(flight_recorder=16, log="off"))
    assert STATE.flight is None                  # no sink: unarmed
    path = metrics_on(tmp_path, flight_recorder=64)
    _serve_stream(n_reqs=4, batch=2)
    obs.flush()
    assert not os.path.exists(path + ".flight.jsonl")


def test_flight_knob_without_sink_on_the_lazy_path(tmp_path):
    """A process whose first obs call is a log line, with
    ``DLAF_FLIGHT_RECORDER`` set and no metrics path, configures from the
    environment once and warns once (the reference recurses forever
    there: its warning re-enters the lazy configure it is part of)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DLAF_")}
    env.update(DLAF_FLIGHT_RECORDER="16", PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", "from dlaf_tpu_torch import obs; "
                          "obs.get_logger('x').info('hello'); print(obs.STATE.flight)"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"
    assert out.stderr.count("DLAF_FLIGHT_RECORDER is set") == 1 and "hello" in out.stderr


def test_breaker_open_trips_flight_with_context(tmp_path):
    path = metrics_on(tmp_path, flight_recorder=64, circuit_threshold=2)
    q = _queue(batch=1, retry_attempts=1, retry_backoff_s=0.0)
    q.submit(Request(op="cholesky", a=_hpd(12))).result()

    def broken(spec, *args):
        raise RuntimeError("injected dispatch failure")

    q.service.run = broken
    for i in range(3):
        with pytest.raises(Exception):
            q.submit(Request(op="cholesky", a=_hpd(12, i)))
    records = obs.read_records(path + ".flight.jsonl")
    assert not obs.validate_records(records, require_flight=True)
    assert records[0]["reason"] == "breaker_open"
    assert "serve" in {r["type"] for r in records[1:]}
    assert [r for r in records[1:] if r.get("event") == "circuit_open"]
    # a run that ends with the breaker open fails --require-resilience
    obs.flush()
    art = obs.read_records(path)
    assert any("left open" in e for e in obs.validate_records(art, require_resilience=True))


def test_overload_shed_trips_flight_once_per_burst(tmp_path):
    path = metrics_on(tmp_path, flight_recorder=64)
    q = _queue(batch=64, max_depth=2, shed=True, clock=FakeClock())
    q.submit(Request(op="cholesky", a=_hpd(12, 0)))
    q.submit(Request(op="cholesky", a=_hpd(12, 1)))
    for i in range(5):
        with pytest.raises(health.OverloadError):
            q.submit(Request(op="cholesky", a=_hpd(12, 2 + i)))
    records = obs.read_records(path + ".flight.jsonl")
    assert records[0]["reason"] == "overload_shed" and records[0]["dump_seq"] == 1
    assert [r for r in records[1:] if r.get("event") == "shed"]
    assert obs.registry().counter("dlaf_serve_shed_total", op="cholesky",
                                  bucket_n=16).value == 5


def test_factorization_exhausted_trips_flight(tmp_path):
    path = metrics_on(tmp_path, flight_recorder=32)
    a = _hpd(8)
    a[2, 1] = a[1, 2] = np.nan
    with pytest.raises(health.FactorizationError):
        health.robust_cholesky("L", Matrix.from_global(a, TileElementSize(4, 4), device="cpu"),
                               max_attempts=2)
    header = obs.read_records(path + ".flight.jsonl")[0]
    assert header["reason"] == "factorization_exhausted" and header["attrs"]["attempts"] == 2


@pytest.mark.parametrize("spread", [False, True])
def test_slo_breach_burst(tmp_path, spread):
    """Three breaches inside one SLO window dump the ring once (the
    cooldown holds through the storm); breaches spread wider than the
    window never trip."""
    clock = FakeClock(1000.0)
    slo.set_clock(clock)
    path = metrics_on(tmp_path, slo_p99_ms=10.0, slo_window_s=5.0, slo_burst=3,
                      flight_recorder=32)
    with obs.span("pre_incident_work", n=1):
        pass
    flight_path = path + ".flight.jsonl"
    for _ in range(2):
        obs.observe_latency("cholesky", 0.5)
        clock.t += 6.0 if spread else 1.0
    assert not os.path.exists(flight_path)
    obs.observe_latency("cholesky", 0.5)
    if spread:
        assert not os.path.exists(flight_path)
        return
    records = obs.read_records(flight_path)
    assert records[0]["reason"] == "slo_breach_burst"
    assert records[0]["attrs"]["breaches"] == 3
    assert not jsinks.validate_records(records, require_flight=True)
    for _ in range(5):
        obs.observe_latency("cholesky", 0.5)
    assert obs.read_records(flight_path)[0]["dump_seq"] == records[0]["dump_seq"]


# ---------------------------------------------------------------------------
# the schema and the knobs
# ---------------------------------------------------------------------------

def _base(rtype, **kw):
    return {"v": 1, "type": rtype, "ts": 0.0, **kw}


def test_trace_stamp_stages_and_flight_schema():
    ok = _base("log", level="info", logger="x", msg="m")
    assert not obs.validate_records([dict(ok, trace_id=["a", "b"], span_id="s")])
    for bad in ({"trace_id": ""}, {"trace_id": []}, {"trace_id": ["a", ""]},
                {"trace_id": 7}, {"span_id": ""}, {"span_id": 3}):
        assert obs.validate_records([dict(ok, **bad)]), bad
    disp = _base("serve", event="dispatch", op="cholesky", bucket_n=16, nrhs=0,
                 dtype="float64", lanes=2, batch=2, cache="hit", dispatch_s=0.1)
    assert not obs.validate_records([dict(disp, stages={"compose_s": 0.0})])
    for bad in ("nope", {"compose_s": -1.0}, {"compose_s": float("nan")}):
        assert obs.validate_records([dict(disp, stages=bad)])
    trig = _base("flight_trigger", reason="breaker_open", dump_seq=1, records=1, attrs={})
    assert not obs.validate_records([trig, ok], require_flight=True)
    assert obs.validate_records([ok], require_flight=True)
    assert obs.validate_records([trig], require_flight=True)
    assert obs.validate_records([dict(trig, reason="bad_reason"), ok])


def test_config_knob_validation(monkeypatch):
    for bad in (dict(metrics_port=-1), dict(metrics_port=70000), dict(slo_p99_ms=-1.0),
                dict(slo_window_s=0.0), dict(slo_burst=-1), dict(flight_recorder=-2)):
        with pytest.raises(ValueError):
            config.initialize(config.Configuration(**bad))
    monkeypatch.setenv("DLAF_SLO_P99_MS", "250")
    monkeypatch.setenv("DLAF_FLIGHT_RECORDER", "128")
    cfg = config.initialize(argv=["--dlaf:slo-window-s=30"])
    assert (cfg.slo_p99_ms, cfg.flight_recorder, cfg.slo_window_s) == (250.0, 128, 30.0)
    assert STATE.flight is None              # no metrics path: unarmed
