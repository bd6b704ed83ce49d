"""The port's fleet serve tier (``dlaf_tpu_torch/fleet``) against the JAX
reference's (``dlaf_tpu/fleet``), and its own contracts, on the CPU.

Where the two packages meet, they are held equal: the raw bytes of a
transport frame; the wire forms of ``Request`` and ``ProgramSpec``
(each package's loads in the other's ``from_wire`` and compares equal);
the ``_bucket_of`` routing strings of a seeded request set; the
membership states under one event script and a fake clock; the six fleet
knobs (defaults, environment, validation); the ``fleet`` record schema
and ``require_fleet`` (both validators accept and reject the same
artifacts, the port's drills' artifacts included); and the protocol
itself (a reference router served by port workers, a port router served
by a reference worker).

The router's drills (``tests/test_fleet.py``, re-run on the port with
in-process CPU workers): results against numpy at the serve tolerance,
bucket co-location, the SIGKILL redispatch, the flight dump, the
heartbeat timeout and the probe's readmission, the transient and
sustained ``fail_fleet_dispatch`` faults, the warm-sibling retrace pin,
the failover-off must-trip, the graceful drain, ``/healthz``, and
``close()`` releasing its threads and its queues. A real worker process
(``python -m dlaf_tpu_torch.fleet.worker --backend cpu``) serves and
drains by SIGTERM; ``--backend cuda`` with no card exits non-zero; and
``Queue.submit(req, trace_id=)`` stamps the request's records.
"""

import gc
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from dlaf_tpu import config as jcfg
from dlaf_tpu.fleet import Router as JRouter
from dlaf_tpu.fleet import connect_worker as j_connect_worker
from dlaf_tpu.fleet import membership as jmembership
from dlaf_tpu.fleet import router as jrouter
from dlaf_tpu.fleet import transport as jtransport
from dlaf_tpu.health import circuit as jcircuit
from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu.obs import validate as jvalidate
from dlaf_tpu.serve import ProgramService as JProgramService
from dlaf_tpu.serve import Queue as JQueue
from dlaf_tpu.serve import programs as jprograms
from dlaf_tpu.serve.queue import Request as JRequest
from dlaf_tpu_torch import config, health, obs
from dlaf_tpu_torch.fleet import (Router, TransportClosed, TransportIdle, connect_worker,
                                  membership, recv_msg, send_msg, transport, worker_site)
from dlaf_tpu_torch.fleet import router as prouter
from dlaf_tpu_torch.fleet.router import RemoteError, _bucket_of
from dlaf_tpu_torch.health import inject
from dlaf_tpu_torch.health.errors import FleetUnavailableError, WorkerLostError
from dlaf_tpu_torch.obs import validate as pvalidate
from dlaf_tpu_torch.obs.sinks import FLEET_EVENTS, validate_records
from dlaf_tpu_torch.serve import ProgramService, Queue, Request, programs, solve_spec
from dlaf_tpu_torch.serve.queue import array_to_wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = ("DLAF_METRICS_PATH", "DLAF_PROGRAM_TELEMETRY", "DLAF_SERVE_BUCKETS", "DLAF_SERVE_BATCH",
       "DLAF_SERVE_DEADLINE_MS", "DLAF_FLEET_WORKERS", "DLAF_FLEET_FAILOVER",
       "DLAF_FLEET_HEARTBEAT_MS", "DLAF_FLEET_HEARTBEAT_TIMEOUT_MS",
       "DLAF_FLEET_RETRY_ATTEMPTS", "DLAF_FLEET_RETRY_BACKOFF_MS", "DLAF_FLIGHT_RECORDER")

#: the six fleet knobs: (field, environment value, parsed value)
KNOBS = (("fleet_workers", "5", 5), ("fleet_heartbeat_ms", "250", 250.0),
         ("fleet_heartbeat_timeout_ms", "9000", 9000.0), ("fleet_failover", "0", False),
         ("fleet_retry_attempts", "7", 7), ("fleet_retry_backoff_ms", "3.5", 3.5))


@pytest.fixture(autouse=True)
def fleet_reset(monkeypatch):
    """Each test leaves the default configuration of both packages, no
    sink and closed breakers behind."""
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    obs._reset_for_tests()
    health.circuit.reset()
    jcircuit.reset()
    config.initialize()
    jcfg.initialize()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def hpd(n, seed=0, dtype=np.float64):
    x = np.random.default_rng(seed).standard_normal((n, n)).astype(dtype)
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def check_chol(ticket):
    """The factor's residual ``|L L^T - A|_F / |A|_F`` within the serve
    budget ``60 n eps``."""
    a = np.asarray(ticket.request.a)
    fac = np.tril(ticket.result())
    res = np.linalg.norm(fac @ fac.T - a) / np.linalg.norm(a)
    assert res <= 60 * len(a) * np.finfo(a.dtype).eps, res


def wait_for(cond, router, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        router.poll()
        time.sleep(0.005)


class Fleet:
    """In-process drill fleet (the reference's ``_Fleet``): a router with an
    injected clock and N worker loops on daemon threads, each its own
    Queue over one SHARED CPU ProgramService (the warm sibling)."""

    def __init__(self, n_workers=2, batch=1, router_kw=None, clock=None):
        self.clock = clock if clock is not None else FakeClock()
        self.router = Router(clock=self.clock, port=0, **(router_kw or {}))
        self.service = ProgramService(device="cpu")
        self.workers = []
        for k in range(n_workers):
            q = Queue(self.service, batch=batch, deadline_s=1e9, buckets=(16,))
            w = connect_worker(self.router.port, k, queue=q, idle_tick_s=0.01)
            threading.Thread(target=w.serve, daemon=True).start()
            self.workers.append(w)
        wait_for(lambda: len(self.router.stats()["workers"]) == n_workers, self.router,
                 "workers never connected")

    def kill_and_wait(self, victim):
        self.workers[victim].kill()
        wait_for(lambda: self.router.stats()["workers"][victim]["state"] == "dead",
                 self.router, "the killed worker never read dead")

    def close(self):
        self.router.close()


def metrics_on(tmp_path, **cfg):
    path = str(tmp_path / "m.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off", **cfg))
    return path


def fleet_records(path):
    return [r for r in obs.read_records(path) if r.get("type") == "fleet"]


def both_validate(records, **require):
    """(port errors, reference errors) of the same records."""
    return (validate_records(records, **require),
            jsinks.validate_records([dict(r) for r in records], **require))


# ---------------------------------------------------------------------------
# Transport: the same bytes, the same failures
# ---------------------------------------------------------------------------

MESSAGES = (
    {"kind": "submit", "seq": 7, "req": {"op": "cholesky"}, "unicode": "π≤1"},
    {"kind": "result", "seq": 0, "ok": True, "arrays": [array_to_wire(np.eye(3))],
     "info": 0, "queue_s": 0.25, "total_s": 1e-7},
    {"kind": "hello", "worker": 2, "pid": 12345},
    {"kind": "warmup", "specs": [solve_spec(batch=4, n=16, nrhs=8, nb=8, dtype="float64",
                                            route=(("f64_gemm_slices", 5),)).to_wire()]},
)


def _frame(mod, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        mod.send_msg(a, msg)
        a.close()
        chunks = []
        while True:
            c = b.recv(1 << 16)
            if not c:
                return b"".join(chunks)
            chunks.append(c)
    finally:
        b.close()


@pytest.mark.parametrize("msg", MESSAGES, ids=[m["kind"] for m in MESSAGES])
def test_frames_are_the_references_bytes(msg):
    port, ref = _frame(transport, msg), _frame(jtransport, msg)
    assert port == ref
    assert struct.unpack(">I", port[:4])[0] == len(port) - 4
    # each package reads the other's frame
    for send, recv in ((transport, jtransport), (jtransport, transport)):
        a, b = socket.socketpair()
        try:
            send.send_msg(a, msg)
            assert recv.recv_msg(b) == json.loads(json.dumps(msg))
        finally:
            a.close()
            b.close()


def test_max_frame_bytes_is_the_references():
    assert transport.MAX_FRAME_BYTES == jtransport.MAX_FRAME_BYTES == 256 << 20


@pytest.fixture(params=["port", "reference"])
def tmod(request):
    return transport if request.param == "port" else jtransport


class TestTransport:
    """``tests/test_fleet.py``'s transport pins, in both packages."""

    def test_eof_raises_closed(self, tmod):
        a, b = socket.socketpair()
        a.close()
        try:
            with pytest.raises(tmod.TransportClosed):
                tmod.recv_msg(b)
        finally:
            b.close()

    def test_eof_mid_frame_raises_closed(self, tmod):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack(">I", 100) + b'{"kind"')
            a.close()
            with pytest.raises(tmod.TransportClosed, match="7/100"):
                tmod.recv_msg(b)
        finally:
            b.close()

    def test_idle_between_frames_keeps_the_stream(self, tmod):
        a, b = socket.socketpair()
        try:
            b.settimeout(0.01)
            with pytest.raises(tmod.TransportIdle):
                tmod.recv_msg(b, idle_ok=True)
            tmod.send_msg(a, {"kind": "ping"})
            assert tmod.recv_msg(b, idle_ok=True) == {"kind": "ping"}
        finally:
            a.close()
            b.close()

    def test_mid_frame_timeout_keeps_reading(self, tmod):
        a, b = socket.socketpair()
        try:
            b.settimeout(0.01)
            payload = b'{"kind": "pong"}'
            a.sendall(struct.pack(">I", len(payload)) + payload[:4])

            def finish():
                time.sleep(0.05)       # several idle ticks mid-frame
                a.sendall(payload[4:])

            threading.Thread(target=finish, daemon=True).start()
            assert tmod.recv_msg(b, idle_ok=True) == {"kind": "pong"}
        finally:
            a.close()
            b.close()

    def test_oversize_frame_refused_both_ways(self, tmod, monkeypatch):
        monkeypatch.setattr(tmod, "MAX_FRAME_BYTES", 64)
        a, b = socket.socketpair()
        try:
            with pytest.raises(ValueError, match="frame"):
                tmod.send_msg(a, {"blob": "x" * 128})
            a.sendall(struct.pack(">I", 1 << 20))
            with pytest.raises(tmod.TransportClosed, match="corrupt"):
                tmod.recv_msg(b)
        finally:
            a.close()
            b.close()


def test_port_exceptions_are_the_references_kinds():
    assert issubclass(TransportClosed, ConnectionError)
    assert issubclass(TransportIdle, TimeoutError)


# ---------------------------------------------------------------------------
# Wire forms and bucket strings
# ---------------------------------------------------------------------------

def _requests(seed=0, count=40):
    """A seeded mix of every op, dtype, flag and rhs shape, as pairs of
    (port, reference) requests over the same arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(1, 300))
        dt = [np.float32, np.float64, np.complex64, np.complex128][i % 4]
        op = ["cholesky", "solve", "eigh"][int(rng.integers(0, 3))]
        a = rng.standard_normal((n, n)).astype(dt)
        kw = dict(op=op, a=a, uplo=str(rng.choice(["L", "U"])),
                  alpha=float(rng.choice([1.0, -0.5])), rid=i if i % 3 else None,
                  deadline_s=1.5 if i % 5 == 0 else None)
        if op == "solve":
            side = str(rng.choice(["L", "R"]))
            free = int(rng.integers(1, 40))
            kw.update(side=side, transa=str(rng.choice(["N", "T", "C"])),
                      diag=str(rng.choice(["N", "U"])),
                      b=rng.standard_normal((n, free) if side == "L" else (free, n)).astype(dt))
        out.append((Request(**kw), JRequest(**kw)))
    return out


def _same_request(x, y):
    np.testing.assert_array_equal(np.asarray(x.a), np.asarray(y.a))
    assert np.asarray(x.a).dtype == np.asarray(y.a).dtype
    assert (x.b is None) == (y.b is None)
    if x.b is not None:
        np.testing.assert_array_equal(np.asarray(x.b), np.asarray(y.b))
    assert (x.op, x.uplo, x.side, x.transa, x.diag, x.alpha, x.rid, x.deadline_s) == \
        (y.op, y.uplo, y.side, y.transa, y.diag, y.alpha, y.rid, y.deadline_s)


def test_request_wire_forms_cross_load():
    for p, j in _requests():
        assert p.to_wire() == j.to_wire()
        _same_request(JRequest.from_wire(p.to_wire()), p)
        _same_request(Request.from_wire(j.to_wire()), j)


SPECS = (dict(op="cholesky", batch=16, n=256, nb=64, dtype="float64"),
         dict(op="solve", batch=4, n=16, nrhs=8, nb=8, dtype="float64", side="R", uplo="U",
              transa="C", diag="U", route=(("f64_gemm_slices", 5),)),
         dict(op="eigh", batch=2, n=32, nb=16, dtype="complex128", with_info=False,
              donate=True, route=(("panel_impl", "xla"), ("f64_gemm_slices", 7))))


@pytest.mark.parametrize("fields", SPECS, ids=[s["op"] for s in SPECS])
def test_program_spec_wire_forms_cross_load(fields):
    p, j = programs.ProgramSpec(**fields), jprograms.ProgramSpec(**fields)
    assert p.to_wire() == j.to_wire()
    assert json.loads(json.dumps(p.to_wire())) == p.to_wire()
    assert programs.ProgramSpec.from_wire(json.loads(json.dumps(p.to_wire()))) == p
    assert programs.ProgramSpec.from_wire(j.to_wire()) == p
    assert jprograms.ProgramSpec.from_wire(p.to_wire()) == j
    assert programs.ProgramSpec.from_wire(p.to_wire()).site == p.site == j.site


@pytest.mark.parametrize("buckets", ["", "24,100,256"])
def test_bucket_strings_are_the_references(buckets, monkeypatch):
    if buckets:
        monkeypatch.setenv("DLAF_SERVE_BUCKETS", buckets)
        config.initialize()
        jcfg.initialize()
    pairs = _requests(seed=3, count=60)
    strings = [_bucket_of(p) for p, _ in pairs]
    assert strings == [jrouter._bucket_of(j) for _, j in pairs]
    assert len(set(strings)) > 20


def test_routing_order_is_the_references():
    """The CRC32 start index over the sorted routable workers, so both
    routers send a seeded stream to the same workers."""
    for p, j in _requests(seed=5, count=30):
        for workers in (1, 2, 3, 5):
            pb, jb = _bucket_of(p), jrouter._bucket_of(j)
            assert prouter.zlib.crc32(pb.encode()) % workers == \
                jrouter.zlib.crc32(jb.encode()) % workers


# ---------------------------------------------------------------------------
# Membership: one event script, the same states
# ---------------------------------------------------------------------------

SCRIPT = (("add", 0), ("add", 1), ("add", 2), ("tick", 4.9), ("beat", 1), ("tick", 5.1),
          ("beat", 2), ("tick", 10.0), ("timed_out",), ("beat", 0), ("tick", 10.5),
          ("mark_draining", 2), ("beat", 2), ("tick", 16.0), ("timed_out",),
          ("mark_dead", 1, "eof"), ("beat", 1), ("mark_dead", 2, "drained"), ("timed_out",),
          ("beat", 0), ("tick", 30.0), ("timed_out",), ("add", 3), ("mark_draining", 1))


def _play(mod):
    clock = FakeClock()
    m = mod.Membership(heartbeat_timeout_s=5.0, clock=clock)
    trail = []
    for step in SCRIPT:
        if step[0] == "tick":
            clock.t = step[1]
        elif step[0] == "timed_out":
            trail.append(("flipped", m.timed_out(clock.t)))
        else:
            getattr(m, step[0])(*step[1:])
        trail.append((m.routable(), m.states()))
    return trail


def test_membership_script_matches_reference():
    port = _play(membership)
    assert port == _play(jmembership)
    flips = [t[1] for t in port if t[0] == "flipped"]
    assert flips == [[0, 1], [0], [], [0]]
    assert port[-1][1][1]["state"] == "dead" and port[-1][1][2]["reason"] == "drained"
    assert membership.ROUTABLE_STATES == jmembership.ROUTABLE_STATES


def test_suspect_stays_routable_and_terminal_states_stay():
    clock = FakeClock()
    m = membership.Membership(heartbeat_timeout_s=5.0, clock=clock)
    m.add(0, pid=11)
    m.add(1, pid=22)
    clock.t = 10.0
    m.beat(1)
    assert m.timed_out(clock.t) == [0]
    assert m.state(0) == "suspect" and m.routable() == [0, 1]
    assert m.timed_out(clock.t) == []
    m.beat(0)
    assert m.state(0) == "up"
    m.mark_dead(0, "eof")
    m.mark_draining(1)
    m.beat(0)
    m.beat(1)
    assert (m.state(0), m.state(1), m.routable()) == ("dead", "draining", [])


# ---------------------------------------------------------------------------
# The fleet knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,env,value", KNOBS, ids=[k[0] for k in KNOBS])
def test_fleet_knob_layers_match_reference(field, env, value, monkeypatch):
    assert getattr(config.Configuration(), field) == getattr(jcfg.Configuration(), field)
    monkeypatch.setenv("DLAF_" + field.upper(), env)
    extra = ({"DLAF_FLEET_HEARTBEAT_MS": "100"} if field == "fleet_heartbeat_timeout_ms"
             else {"DLAF_FLEET_HEARTBEAT_TIMEOUT_MS": "100000"})
    for k, v in extra.items():
        monkeypatch.setenv(k, v)
    got, want = config.update_configuration(), jcfg.update_configuration()
    assert getattr(got, field) == getattr(want, field) == value
    arg = f"--dlaf:{field.replace('_', '-')}={env}"
    monkeypatch.delenv("DLAF_" + field.upper())
    assert getattr(config.update_configuration(argv=[arg]), field) == value


BAD = (("fleet_workers", 0), ("fleet_heartbeat_ms", 0.0), ("fleet_heartbeat_timeout_ms", 10.0),
       ("fleet_retry_attempts", 0), ("fleet_retry_backoff_ms", -1.0))


@pytest.mark.parametrize("field,bad", BAD, ids=[b[0] for b in BAD])
def test_fleet_knob_validation_matches_reference(field, bad):
    with pytest.raises(ValueError, match=field) as port:
        config.update_configuration(config.Configuration(**{field: bad}))
    with pytest.raises(ValueError, match=field) as ref:
        jcfg._validate(jcfg.Configuration(**{field: bad}))
    assert str(port.value) == str(ref.value)


def test_router_reads_the_knobs(monkeypatch):
    for k, v in (("HEARTBEAT_MS", "200"), ("HEARTBEAT_TIMEOUT_MS", "700"),
                 ("FAILOVER", "0"), ("RETRY_ATTEMPTS", "4"), ("RETRY_BACKOFF_MS", "2")):
        monkeypatch.setenv("DLAF_FLEET_" + k, v)
    config.initialize()
    r = Router(port=0)
    try:
        assert (r.heartbeat_s, r.membership.heartbeat_timeout_s, r.failover,
                r.retry_attempts, r.retry_backoff_s) == (0.2, 0.7, False, 4, 0.002)
    finally:
        r.close()


@pytest.mark.parametrize("workers", [3, 5])
def test_chip_smoke_fleet_layout_reads_fleet_workers(workers, monkeypatch):
    """``chip_smoke.fleet_phase``, the port's launcher, sizes its main
    router's fleet by ``fleet_workers``; the three fleets' worker indices
    (their ``fleet.worker{k}`` breakers and ``%r`` shards) never overlap,
    and fewer than three workers for legs b and c are refused."""
    import chip_smoke as cs

    monkeypatch.setenv("DLAF_FLEET_WORKERS", str(workers))
    config.initialize()
    layout = dict(cs._fleet_layout())
    assert layout["w"] == tuple(range(workers))
    assert (len(layout["one"]), len(layout["off"])) == (1, 2)
    ks = [k for v in layout.values() for k in v]
    assert len(ks) == len(set(ks)) == workers + 3
    monkeypatch.setenv("DLAF_FLEET_WORKERS", "2")
    config.initialize()
    with pytest.raises(ValueError, match="fleet_workers=2"):
        cs._fleet_layout()


# ---------------------------------------------------------------------------
# The router's drills (in-process CPU workers)
# ---------------------------------------------------------------------------

class TestRouterDispatch:
    def test_fan_out_results_and_bucket_colocation(self, tmp_path):
        path = metrics_on(tmp_path)
        fleet = Fleet(n_workers=2, batch=1)
        try:
            tickets = [fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=i)))
                       for i in range(4)]
            assert fleet.router.join(tickets, timeout_s=60)
            for t in tickets:
                check_chol(t)
                assert t.info == 0 and t.total_s >= 0.0
            assert len({t.worker for t in tickets}) == 1
            st = fleet.router.stats()
            assert st["unresolved"] == 0 and st["lost"] == 0
        finally:
            fleet.close()
        obs.flush()
        recs = fleet_records(path)
        assert [r["event"] for r in recs].count("worker_up") == 2
        routes = [r for r in recs if r["event"] == "route"]
        assert sorted(r["seq"] for r in routes) == [0, 1, 2, 3]
        assert all(r.get("trace_id") for r in routes)
        assert both_validate(obs.read_records(path), require_fleet=True) == ([], [])

    def test_distinct_buckets_spread_across_workers(self):
        fleet = Fleet(n_workers=2, batch=1)
        try:
            reqs = [Request(op="cholesky", a=hpd(12)),
                    Request(op="cholesky", a=hpd(12).astype(np.float32)),
                    Request(op="cholesky", a=hpd(12), uplo="U"),
                    Request(op="solve", a=hpd(12), b=np.ones((12, 2)))]
            assert len({_bucket_of(r) for r in reqs}) == 4
            tickets = [fleet.router.submit(r) for r in reqs]
            assert fleet.router.join(tickets, timeout_s=60)
            assert len({t.worker for t in tickets}) == 2
            x = tickets[3].result()
            np.testing.assert_allclose(np.tril(hpd(12)) @ x, np.ones((12, 2)), atol=1e-12)
        finally:
            fleet.close()

    def test_no_workers_fails_fast_and_keeps_nothing(self):
        router = Router(clock=FakeClock(), port=0)
        try:
            with pytest.raises(FleetUnavailableError):
                router.submit(Request(op="cholesky", a=hpd(12)))
            assert router.stats()["unresolved"] == 0
        finally:
            router.close()

    def test_worker_acked_failure_is_terminal_remote_error(self):
        router = Router(clock=FakeClock(), port=0)
        stub = socket.create_connection(("127.0.0.1", router.port))
        try:
            stub.settimeout(5.0)
            send_msg(stub, {"kind": "hello", "worker": 0, "pid": 1})
            wait_for(lambda: router.stats()["workers"], router, "no hello")
            t = router.submit(Request(op="cholesky", a=hpd(12)))
            msg = recv_msg(stub)
            assert msg["kind"] == "submit" and msg["seq"] == t.seq
            assert msg["trace_id"] == t.trace_id
            send_msg(stub, {"kind": "result", "seq": t.seq, "ok": False, "worker": 0,
                            "error": {"type": "OverloadError", "message": "queue full"}})
            assert router.join([t], timeout_s=10)
            with pytest.raises(RuntimeError, match="request failed"):
                t.result()
            assert isinstance(t.error, RemoteError) and t.error.etype == "OverloadError"
            st = router.stats()
            assert st["redispatches"] == 0 and st["lost"] == 0
        finally:
            stub.close()
            router.close()


class TestFailover:
    def test_worker_kill_redispatches_every_unacked_ticket(self, tmp_path):
        path = metrics_on(tmp_path)
        fleet = Fleet(n_workers=2, batch=8)     # batch >> submits: unacked
        try:
            tickets = [fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=i)))
                       for i in range(3)]
            victim = tickets[0].worker
            fleet.kill_and_wait(victim)
            fleet.router.flush()
            assert fleet.router.join(tickets, timeout_s=60)
            for t in tickets:
                check_chol(t)
                assert t.worker == 1 - victim and t.redispatched == 1
                assert t.attempts == [victim, 1 - victim]
            st = fleet.router.stats()
            assert st["redispatches"] == 3 and st["lost"] == 0
        finally:
            fleet.close()
        obs.flush()
        recs = fleet_records(path)
        dead = [r for r in recs if r["event"] == "worker_dead"]
        redis = [r for r in recs if r["event"] == "redispatch"]
        assert len(dead) == 1 and dead[0]["attrs"]["reason"] == "eof"
        assert len(redis) == 3 and all(r["attrs"]["from"] == victim for r in redis)
        routes = {r["trace_id"] for r in recs if r["event"] == "route"}
        assert all(r["trace_id"] in routes for r in redis)
        # the sibling's serve records carry the router's trace IDs
        served = {r["trace_id"] for r in obs.read_records(path)
                  if r.get("type") == "serve" and r.get("event") == "request"}
        assert served == routes
        assert both_validate(obs.read_records(path), require_fleet=True) == ([], [])

    def test_worker_death_trips_the_flight_recorder(self, tmp_path):
        path = metrics_on(tmp_path, flight_recorder=64)
        dump = path + ".flight.jsonl"
        fleet = Fleet(n_workers=2, batch=8)
        try:
            t = fleet.router.submit(Request(op="cholesky", a=hpd(12)))
            fleet.workers[t.worker].kill()
            wait_for(lambda: os.path.exists(dump), fleet.router, "no flight dump")
            recs = obs.read_records(dump)
            trig = [r for r in recs if r.get("type") == "flight_trigger"]
            assert trig and trig[-1]["reason"] == "fleet_worker_down"
            assert trig[-1]["attrs"]["unacked"] == 1 and trig[-1]["attrs"]["failover"] is True
            assert both_validate(recs, require_flight=True) == ([], [])
        finally:
            fleet.close()

    def test_heartbeat_timeout_suspects_reroutes_and_readmits(self):
        clock = FakeClock()
        router = Router(clock=clock, port=0, heartbeat_s=1.0, heartbeat_timeout_s=5.0)
        wedged = socket.create_connection(("127.0.0.1", router.port))
        wedged.settimeout(10.0)
        send_msg(wedged, {"kind": "hello", "worker": 0, "pid": 1})
        try:
            wait_for(lambda: router.stats()["workers"], router, "no hello")
            t1 = router.submit(Request(op="cholesky", a=hpd(12)))
            assert t1.worker == 0 and recv_msg(wedged)["kind"] == "submit"
            q = Queue(ProgramService(device="cpu"), batch=1, deadline_s=1e9, buckets=(16,))
            w1 = connect_worker(router.port, 1, queue=q, idle_tick_s=0.01)
            threading.Thread(target=w1.serve, daemon=True).start()
            wait_for(lambda: len(router.stats()["workers"]) == 2, router, "no sibling")
            clock.t = 1.5               # a ping edge: only the sibling pongs
            router.poll()
            wait_for(lambda: router.stats()["workers"][1]["last_seen"] >= 1.5, router,
                     "the sibling never ponged")
            clock.t = 6.0
            router.poll()
            st = router.stats()
            assert (st["workers"][0]["state"], st["workers"][1]["state"]) == ("suspect", "up")
            assert st["breakers"][0] == "open"
            assert router.join([t1], timeout_s=60)
            check_chol(t1)
            assert t1.worker == 1 and t1.redispatched == 1
            router._send(1, {"kind": "drain"})
            wait_for(lambda: router.stats()["workers"][1]["state"] == "dead", router,
                     "the sibling never drained")
            clock.t = 6.0 + 31.0        # past the default 30 s cooldown
            t2 = router.submit(Request(op="cholesky", a=hpd(12, seed=9)))
            assert t2.worker == 0 and router.stats()["breakers"][0] == "half_open"
            msg = recv_msg(wedged)
            while msg["kind"] != "submit":
                msg = recv_msg(wedged)
            assert msg["seq"] == t2.seq
            send_msg(wedged, {"kind": "result", "seq": t2.seq, "ok": True, "worker": 0,
                              "arrays": [array_to_wire(np.eye(12))], "info": 0,
                              "queue_s": 0.0, "total_s": 0.0})
            assert router.join([t2], timeout_s=10)
            st = router.stats()
            assert st["breakers"][0] == "closed" and st["workers"][0]["state"] == "up"
        finally:
            wedged.close()
            router.close()

    def test_failover_disabled_loses_loudly_and_validators_reject(self, tmp_path):
        path = metrics_on(tmp_path)
        fleet = Fleet(n_workers=2, batch=8, router_kw={"failover": False})
        try:
            tickets = [fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=i)))
                       for i in range(2)]
            fleet.workers[tickets[0].worker].kill()
            assert fleet.router.join(tickets, timeout_s=30)
            for t in tickets:
                with pytest.raises(RuntimeError) as ei:
                    t.result()
                assert isinstance(ei.value.__cause__, WorkerLostError)
            st = fleet.router.stats()
            assert st["lost"] == 2 and st["redispatches"] == 0
        finally:
            fleet.close()
        obs.flush()
        recs = obs.read_records(path)
        lost = [r for r in recs if r.get("type") == "fleet" and r["event"] == "ticket_lost"]
        assert len(lost) == 2 and all(r["attrs"]["reason"] == "eof" for r in lost)
        port, ref = both_validate(recs, require_fleet=True)
        assert any("ticket_lost" in e for e in port) and any("ticket_lost" in e for e in ref)
        assert both_validate(recs) == ([], [])


class TestInjectedDispatchFaults:
    def test_transient_fault_retries_into_the_same_worker(self, tmp_path):
        path = metrics_on(tmp_path)
        fleet = Fleet(n_workers=2, batch=1)
        try:
            t0 = fleet.router.submit(Request(op="cholesky", a=hpd(12)))
            assert fleet.router.join([t0], timeout_s=60)
            with inject.fail_fleet_dispatch(nth=0, count=1):
                t1 = fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=5)))
            assert t1.worker == t0.worker
            assert fleet.router.join([t1], timeout_s=60)
            check_chol(t1)
        finally:
            fleet.close()
        obs.flush()
        retries = [r for r in obs.read_records(path) if r.get("type") == "resilience"
                   and r["event"] == "retry" and r["site"] == "fleet.dispatch"]
        assert len(retries) == 1

    def test_sustained_fault_opens_the_breaker_and_reroutes(self):
        fleet = Fleet(n_workers=2, batch=1)
        try:
            t0 = fleet.router.submit(Request(op="cholesky", a=hpd(12)))
            assert fleet.router.join([t0], timeout_s=60)
            preferred = t0.worker
            with inject.fail_fleet_dispatch(nth=0, count=3):
                t1 = fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=5)))
                assert t1.worker == 1 - preferred
                assert fleet.router.stats()["breakers"][preferred] == "open"
            # the fleet. breakers are reset on exit
            assert health.circuit.peek(worker_site(preferred)) is None
            assert fleet.router.join([t1], timeout_s=60)
            check_chol(t1)
        finally:
            fleet.close()

    def test_fail_fleet_dispatch_schedule_and_reentrance(self):
        seen = []
        with inject.fail_fleet_dispatch(nth=1, every=2):
            with pytest.raises(RuntimeError, match="not reentrant"):
                with inject.fail_fleet_dispatch():
                    pass
            for _ in range(6):
                try:
                    inject.maybe_fail_fleet_dispatch()
                    seen.append(0)
                except RuntimeError:
                    seen.append(1)
            inject.maybe_fail_dispatch()     # the serve schedule is its own
        assert seen == [0, 1, 0, 1, 0, 1]
        inject.maybe_fail_fleet_dispatch()   # disarmed on exit
        with pytest.raises(ValueError):
            with inject.fail_fleet_dispatch(count=0):
                pass

    def test_redispatched_bucket_reuses_the_siblings_warm_program(self, tmp_path):
        """The warm-failover pin: both workers warm on a bucket, a kill and
        its redispatch compile nothing: ``dlaf_retrace_total`` of the
        bucket's site stays at its first value."""
        metrics_on(tmp_path, program_telemetry=True)
        fleet = Fleet(n_workers=2, batch=2)
        try:
            sample = [Request(op="cholesky", a=hpd(16, seed=i)) for i in range(2)]
            (spec,) = fleet.workers[0].queue.warmup_specs(sample)
            walls = fleet.router.warmup([spec], timeout_s=300.0)
            assert sorted(walls) == [0, 1]
            counter = obs.registry().counter("dlaf_retrace_total", site=spec.site)
            warm = counter.value
            assert warm == 1            # one shared service: one compile
            tickets = [fleet.router.submit(r) for r in sample]
            fleet.kill_and_wait(tickets[0].worker)
            fleet.router.flush()
            assert fleet.router.join(tickets, timeout_s=60)
            for t in tickets:
                check_chol(t)
            assert counter.value == warm
            assert fleet.service.stats()["misses"] == 0
        finally:
            fleet.close()


class TestGracefulDrain:
    def test_drain_hands_back_undispatched_with_zero_redispatches(self, tmp_path):
        path = metrics_on(tmp_path)
        fleet = Fleet(n_workers=2, batch=8)
        try:
            tickets = [fleet.router.submit(Request(op="cholesky", a=hpd(12, seed=i)))
                       for i in range(3)]
            victim = tickets[0].worker
            fleet.workers[victim].request_drain()      # the SIGTERM stand-in
            wait_for(lambda: fleet.router.stats()["workers"][victim]["state"] == "dead",
                     fleet.router, "never drained", timeout=15)
            fleet.router.flush()
            assert fleet.router.join(tickets, timeout_s=60)
            for t in tickets:
                check_chol(t)
                assert t.worker == 1 - victim and t.redispatched == 0
            st = fleet.router.stats()
            assert (st["handbacks"], st["redispatches"], st["lost"]) == (3, 0, 0)
            assert st["workers"][victim]["reason"] == "drained"
        finally:
            fleet.close()
        obs.flush()
        events = [r["event"] for r in fleet_records(path)]
        assert (events.count("handback"), events.count("redispatch"), events.count("draining"),
                events.count("drained")) == (3, 0, 1, 1)
        assert both_validate(obs.read_records(path), require_fleet=True) == ([], [])


class TestFleetHealth:
    def test_healthz_aggregates_worker_payloads(self):
        fleet = Fleet(n_workers=2, batch=1)
        try:
            view = fleet.router.healthz(timeout_s=30.0)
            assert view["status"] == "ok" and sorted(view["workers"]) == [0, 1]
            for payload in view["workers"].values():
                assert payload["status"] == "ok"
                assert "queues" in payload and "breakers" in payload
            assert view["fleet"]["lost"] == 0
        finally:
            fleet.close()

    def test_router_lands_on_the_exporter_healthz(self):
        fleet = Fleet(n_workers=1, batch=1)
        try:
            payload = obs.exporter.healthz_payload()
            assert payload["fleet"][-1]["workers"][0]["state"] == "up"
            assert json.loads(json.dumps(payload))["fleet"][-1]["workers"]["0"]["state"] == "up"
        finally:
            fleet.close()

    def test_degraded_when_a_worker_is_dead(self):
        fleet = Fleet(n_workers=2, batch=1)
        try:
            fleet.kill_and_wait(0)
            assert fleet.router.healthz(timeout_s=10.0)["status"] == "degraded"
        finally:
            fleet.close()

    def test_close_releases_worker_threads_and_healthz_queues(self):
        before = {t.ident for t in threading.enumerate()}
        fleet = Fleet(n_workers=2, batch=1)
        queue_refs = [weakref.ref(w.queue) for w in fleet.workers]
        router_ref = weakref.ref(fleet.router)
        fleet.close()
        deadline = time.monotonic() + 10
        while True:
            leaked = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
            if not leaked:
                break
            assert time.monotonic() < deadline, f"fleet threads leaked past close(): {leaked}"
            time.sleep(0.01)
        del fleet
        gc.collect()
        assert [r() for r in queue_refs] == [None, None]
        assert router_ref() is None and router_ref not in obs.exporter.live_fleets()


def test_worker_sends_whole_frames_to_a_slow_reader():
    """A result frame of a real bucket goes out whole however long the
    router takes to read it: the worker's idle tick (10 ms here) bounds its
    receives only. The router's end holds a small receive buffer and reads
    half a second late."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    q = Queue(ProgramService(device="cpu"), batch=1, deadline_s=1e9)
    w = connect_worker(srv.getsockname()[1], 0, queue=q, idle_tick_s=0.01)
    w.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    loop = threading.Thread(target=w.serve, daemon=True)
    loop.start()
    conn, _ = srv.accept()
    try:
        conn.settimeout(30.0)
        assert recv_msg(conn)["kind"] == "hello"
        a = hpd(200)
        send_msg(conn, {"kind": "submit", "seq": 0, "trace_id": "ab" * 8,
                        "req": Request(op="cholesky", a=a).to_wire()})
        time.sleep(0.5)
        msg = recv_msg(conn)
        assert msg["kind"] == "result" and msg["ok"], msg.get("error")
        fac = np.tril(prouter.array_from_wire(msg["arrays"][0]))
        assert np.linalg.norm(fac @ fac.T - a) / np.linalg.norm(a) <= 60 * 200 * 2.0 ** -52
        send_msg(conn, {"kind": "ping"})
        assert recv_msg(conn)["kind"] == "pong"      # the worker is still serving
    finally:
        conn.close()
        srv.close()
        loop.join(timeout=10)
    assert not loop.is_alive()


# ---------------------------------------------------------------------------
# The protocol across the packages
# ---------------------------------------------------------------------------

def test_reference_router_served_by_port_workers():
    router = JRouter(clock=FakeClock(), port=0)
    svc = ProgramService(device="cpu")
    try:
        for k in range(2):
            q = Queue(svc, batch=1, deadline_s=1e9, buckets=(16,))
            w = connect_worker(router.port, k, queue=q, idle_tick_s=0.01)
            threading.Thread(target=w.serve, daemon=True).start()
        wait_for(lambda: len(router.stats()["workers"]) == 2, router, "no port workers")
        reqs = [JRequest(op="cholesky", a=hpd(12, seed=i)) for i in range(3)]
        reqs.append(JRequest(op="eigh", a=hpd(10)))
        tickets = [router.submit(r) for r in reqs]
        assert router.join(tickets, timeout_s=60)
        for t in tickets[:3]:
            check_chol(t)
        w_, v = tickets[3].result()
        np.testing.assert_allclose(v @ np.diag(w_) @ v.T, hpd(10), atol=1e-11)
        router.drain_fleet(timeout_s=30)
        wait_for(lambda: all(m["state"] == "dead" for m in router.stats()["workers"].values()),
                 router, "the port workers never drained")
        st = router.stats()
        assert st["handbacks"] == 0
        assert all(m["reason"] == "drained" for m in st["workers"].values())
    finally:
        router.close()


def test_port_router_served_by_a_reference_worker():
    router = Router(clock=FakeClock(), port=0)
    try:
        q = JQueue(JProgramService(), batch=1, deadline_s=1e9, buckets=(16,))
        w = j_connect_worker(router.port, 0, queue=q, idle_tick_s=0.01)
        threading.Thread(target=w.serve, daemon=True).start()
        wait_for(lambda: router.stats()["workers"], router, "no reference worker")
        tickets = [router.submit(Request(op="cholesky", a=hpd(12, seed=i))) for i in range(2)]
        assert router.join(tickets, timeout_s=120)
        for t in tickets:
            check_chol(t)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# The fleet record and require_fleet, in both validators
# ---------------------------------------------------------------------------

def rec(**over):
    base = {"type": "fleet", "v": 1, "ts": 1.0, "event": "route", "worker": 0, "seq": 3,
            "trace_id": "ab12" * 4, "attrs": {}}
    base.update(over)
    return base


def membership_rec(**over):
    r = rec(**over)
    del r["seq"], r["trace_id"]
    return r


def test_fleet_events_are_the_references():
    assert FLEET_EVENTS == jsinks.FLEET_EVENTS
    ticket_scoped = ("route", "redispatch", "handback", "ticket_lost")
    recs = [rec(event=e) if e in ticket_scoped else membership_rec(event=e)
            for e in FLEET_EVENTS]
    assert both_validate(recs) == ([], [])


@pytest.mark.parametrize("over,msg", [
    ({"event": "teleport"}, "fleet event"),
    ({"worker": None}, "worker"),
    ({"worker": -1}, "worker"),
    ({"worker": True}, "worker"),
    ({"seq": None}, "seq"),
    ({"seq": -2}, "seq"),
    ({"trace_id": None}, "trace-stamped"),
    ({"attrs": "x"}, "attrs"),
])
def test_schema_rejections_match_reference(over, msg):
    port, ref = both_validate([rec(**over)])
    assert port and msg in port[0], port
    assert port == ref


DEAD_EOF = membership_rec(event="worker_dead", attrs={"reason": "eof"})
DRAINED = membership_rec(event="worker_dead", attrs={"reason": "drained"})
ARTIFACTS = (
    ("good", [rec()], True),
    ("no-route", [membership_rec(event="worker_up")], False),
    ("ticket-lost", [rec(), rec(event="ticket_lost", seq=4)], False),
    ("ungraceful-no-redispatch", [rec(), DEAD_EOF], False),
    ("ungraceful-redispatched", [rec(), DEAD_EOF, rec(event="redispatch", seq=5)], True),
    ("drained", [rec(), DRAINED], True),
)


@pytest.mark.parametrize("records,ok", [a[1:] for a in ARTIFACTS], ids=[a[0] for a in ARTIFACTS])
def test_require_fleet_agrees_with_reference(records, ok):
    port, ref = both_validate(records, require_fleet=True)
    assert port == ref
    assert (port == []) == ok, port


@pytest.mark.parametrize("records,ok", [a[1:] for a in ARTIFACTS], ids=[a[0] for a in ARTIFACTS])
def test_validate_cli_require_fleet_agrees_with_reference(records, ok, tmp_path, capsys):
    path = tmp_path / "a.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    want = 0 if ok else 1
    assert pvalidate.main([str(path), "--require-fleet"]) == want
    assert jvalidate.main([str(path), "--require-fleet"]) == want
    assert pvalidate.main([str(path)]) == 0


# ---------------------------------------------------------------------------
# A real worker process, the backend and trace_id
# ---------------------------------------------------------------------------

def _spawn_worker(port, k, *extra, env=None):
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT, DLAF_LOG="off")
    return subprocess.Popen([sys.executable, "-m", "dlaf_tpu_torch.fleet.worker", "--connect",
                             f"127.0.0.1:{port}", "--worker", str(k), *extra],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_worker_process_serves_and_drains_on_sigterm(tmp_path):
    router = Router(port=0)
    art = str(tmp_path / "w.r%r.jsonl")
    env = dict(os.environ, DLAF_METRICS_PATH=art, DLAF_SERVE_DEADLINE_MS="60000",
               DLAF_SERVE_BATCH="4")
    proc = _spawn_worker(router.port, 3, "--backend", "cpu", env=env)
    try:
        wait_for(lambda: router.stats()["workers"], router, "the worker never said hello",
                 timeout=120)
        assert router.stats()["workers"][3]["pid"] == proc.pid
        tickets = [router.submit(Request(op="cholesky", a=hpd(12, seed=i))) for i in range(5)]
        # four fill a batch and come back; the fifth waits in a partial one
        wait_for(lambda: sum(t.resolved() for t in tickets) == 4, router, "no batch",
                 timeout=60)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        wait_for(lambda: router.stats()["workers"][3]["state"] == "dead", router, "no drain")
        st = router.stats()
        assert st["workers"][3]["reason"] == "drained" and st["redispatches"] == 0
        for t in tickets[:4]:
            check_chol(t)
        # the handback found no sibling: the fifth ticket fails loudly
        assert isinstance(tickets[4].error, FleetUnavailableError)
    finally:
        router.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = obs.read_records(str(tmp_path / "w.r3.jsonl"))
    served = [r for r in recs if r.get("type") == "serve" and r.get("event") == "request"]
    assert {r["trace_id"] for r in served} == {t.trace_id for t in tickets[:4]}
    assert all(r["rank"] == 3 for r in recs)
    drained = [r for r in recs if r.get("type") == "resilience" and r["event"] == "drain"]
    assert [r["trace_id"] for r in drained] == [tickets[4].trace_id]


def test_worker_process_without_a_card_fails_loudly():
    with socket.create_server(("127.0.0.1", 0)) as srv:
        proc = _spawn_worker(srv.getsockname()[1], 0)
        _, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert b"--backend cuda requested but no CUDA device" in err


def test_submit_adopts_the_callers_trace_id(tmp_path):
    path = metrics_on(tmp_path)
    q = Queue(ProgramService(device="cpu"), batch=2, deadline_s=1e9, buckets=(16,))
    t1 = q.submit(Request(op="cholesky", a=hpd(12)), trace_id="feedfacecafebeef")
    t2 = q.submit(Request(op="cholesky", a=hpd(12, seed=1)))
    assert t1.trace_id == "feedfacecafebeef" and t2.trace_id != t1.trace_id
    assert t1.done and t2.done
    obs.flush()
    recs = obs.read_records(path)
    mine = [r for r in recs if obs.trace_matches(r, "feedfacecafebeef")]
    req = [r for r in mine if r.get("type") == "serve" and r.get("event") == "request"]
    assert len(req) == 1 and req[0]["trace_id"] == "feedfacecafebeef"
    disp = [r for r in recs if r.get("type") == "serve" and r.get("event") == "dispatch"]
    assert disp[0]["trace_id"] == ["feedfacecafebeef", t2.trace_id]
