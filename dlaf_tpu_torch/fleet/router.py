"""Fleet router: durable-ticket dispatch across serve workers.

Port of ``dlaf_tpu/fleet/router.py``. Requests enter here, get a durable
router-owned :class:`FleetTicket`, and are sharded bucket by bucket across
N :mod:`.worker` replicas over the :mod:`.transport` framing. The
contract, in order of importance:

* **Zero loss.** A ticket belongs to the router until the worker's
  ``result`` acknowledgement arrives. Worker death (socket EOF, as after a
  SIGKILL, or a heartbeat timeout, as of a wedged worker) re-dispatches
  every unacknowledged ticket to a sibling through
  :mod:`..health.policy`; with failover off (``DLAF_FLEET_FAILOVER=0``)
  the tickets fail with :class:`..health.errors.WorkerLostError` and
  ``ticket_lost`` fleet records, which ``--require-fleet`` rejects: a lost
  ticket is an open incident, never a silent drop. The semantics are
  AT-LEAST-ONCE: a timed-out but live worker may still complete a
  re-dispatched ticket; the first acknowledgement wins, later ones drop.
* **Breaker-aware routing.** Each worker is gated by the circuit breaker
  of site ``fleet.worker{k}`` (:mod:`..health.circuit`): dispatch faults
  and heartbeat timeouts open it, candidate selection skips an open
  breaker, and readmission is the half-open probe: one real request
  probes the recovered worker.
* **Determinism.** No decision is taken off a router clock edge
  (``submit``/``poll``/``flush``): reader threads only queue messages and
  record when they last heard a worker; the heartbeat timeout is read
  against the injected ``clock`` at ``poll``. With a fake clock and the
  seeded :func:`..health.inject.fail_fleet_dispatch` schedule a failover
  drill replays exactly.
* **Records.** Every routing decision is a ``fleet`` JSONL record
  (``route``/``redispatch``/``handback``/``worker_up``/``worker_dead``/
  ``heartbeat_timeout``/``draining``/``drained``/``probe``/
  ``ticket_lost``) stamped with the ticket's trace ID; a worker's death
  trips the flight recorder (``fleet_worker_down``) with the decision
  already in the ring; the router registers on ``/healthz``, and
  :meth:`Router.healthz` gathers the workers' payloads into one view.

Bucket co-location: a ticket routes by a stable bucket string (op, bucket
ceiling, rhs ceiling, dtype, flags), the same string the reference builds
for an equal request, whose CRC32 indexes the sorted routable workers: one
bucket's requests land on one worker and fill its batches, and a failover
moves whole buckets to a sibling. The port has no persistent compile
cache, so a sibling is warm for a bucket when :meth:`Router.warmup` has
sent it that bucket's spec.
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
import zlib
from collections import deque
from typing import Callable, Optional

import numpy as np

from .. import obs
from ..config import get_configuration
from ..health import circuit as _circuit
from ..health.errors import FleetUnavailableError, WorkerLostError
from ..health.policy import RetryPolicy, with_policy
from ..obs import flight
from ..serve.queue import Request, array_from_wire, bucket_ceiling, rhs_ceiling
from . import transport
from .membership import Membership

#: The policy site of a router ticket dispatch (resilience records,
#: ``dlaf_retry_total{site}``, the ``inject.hang`` target).
DISPATCH_SITE = "fleet.dispatch"


def worker_site(worker: int) -> str:
    """The breaker site of one worker (``dlaf_circuit_state{site}``)."""
    return f"fleet.worker{int(worker)}"


class RemoteError(RuntimeError):
    """A worker processed a request and acknowledged a failure (shed,
    expired, dispatch exhausted, ...). Final: the request WAS handled;
    re-dispatch applies to lost tickets only.

    Attributes:
        worker: the worker that failed the request.
        etype: the worker-side exception type name.
        message: the worker-side message.
    """

    def __init__(self, worker: int, etype: str, message: str):
        self.worker = int(worker)
        self.etype = str(etype)
        self.message = str(message)
        super().__init__(f"worker {self.worker}: {self.etype}: {self.message}")


class FleetTicket:
    """Durable router-owned handle of one accepted request: its wire form
    (kept for re-dispatch), the trace ID every related record carries, and
    the workers it was sent to. ``result()`` is
    :meth:`..serve.queue.Ticket.result`'s: the unpadded host result, or a
    raise that names the cause."""

    def __init__(self, request: Request, seq: int, submitted: float):
        self.request = request
        self.seq = int(seq)
        self.submitted = submitted
        self.wire = request.to_wire()
        self.trace_id = obs.new_trace_id()
        self.bucket = _bucket_of(request)
        self.worker: Optional[int] = None
        self.attempts: list = []        # workers dispatched to, in order
        self.redispatched = 0
        self.done = False
        self.error: Optional[BaseException] = None
        self.info: Optional[int] = None
        self.queue_s: Optional[float] = None
        self.total_s: Optional[float] = None
        self._result = None

    def resolved(self) -> bool:
        return self.done or self.error is not None

    def result(self):
        if self.error is not None:
            raise RuntimeError(f"fleet ticket {self.seq}: request failed "
                               f"({type(self.error).__name__})") from self.error
        if not self.done:
            raise RuntimeError(f"fleet ticket {self.seq} is still in flight; "
                               "Router.join()/poll() drive completion")
        return self._result


def _bucket_of(req: Request) -> str:
    """The bucket-routing string: the fields the serve queue buckets by,
    so co-located tickets batch together; equal to the reference's for an
    equal request."""
    a = np.asarray(req.a)
    n = bucket_ceiling(a.shape[0])
    nrhs = 0
    if req.op == "solve":
        b = np.asarray(req.b)
        free = b.shape[1] if req.side == "L" else b.shape[0]
        nrhs = rhs_ceiling(free)
    return (f"{req.op}.n{n}.r{nrhs}.{a.dtype.name}"
            f".{req.uplo}{req.side}{req.transa}{req.diag}")


class Router:
    """The fleet front tier (module docstring).

    ``heartbeat_s``/``heartbeat_timeout_s``/``failover``/
    ``retry_attempts``/``retry_backoff_s`` default to the ``fleet_*``
    knobs; ``clock`` is injectable for deterministic drills. The router
    listens on ``host:port`` (port 0: the OS picks; read :attr:`port`) and
    workers dial in with a ``hello``."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 heartbeat_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 failover: Optional[bool] = None,
                 retry_attempts: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 host: str = "127.0.0.1", port: int = 0):
        cfg = get_configuration()
        self.clock = clock
        self.heartbeat_s = float(cfg.fleet_heartbeat_ms / 1e3 if heartbeat_s is None
                                 else heartbeat_s)
        timeout_s = float(cfg.fleet_heartbeat_timeout_ms / 1e3 if heartbeat_timeout_s is None
                          else heartbeat_timeout_s)
        self.failover = bool(cfg.fleet_failover if failover is None else failover)
        self.retry_attempts = int(cfg.fleet_retry_attempts if retry_attempts is None
                                  else retry_attempts)
        self.retry_backoff_s = float(cfg.fleet_retry_backoff_ms / 1e3 if retry_backoff_s is None
                                     else retry_backoff_s)
        self.membership = Membership(heartbeat_timeout_s=timeout_s, clock=clock)
        self._lock = threading.RLock()
        self._seq = itertools.count()
        self._tickets: dict = {}        # seq -> unresolved FleetTicket
        self._assigned: dict = {}       # worker -> set of unacknowledged seqs
        self._socks: dict = {}          # worker -> socket
        self._inbox: deque = deque()    # (worker, msg) from the readers
        self._replies: dict = {}        # (worker, kind) -> msg
        self._last_ping = self.clock()
        self._closing = False
        self.redispatches = 0
        self.handbacks = 0
        self.lost = 0
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True, name="fleet-accept").start()
        # on the live /healthz last, once fully built
        obs.exporter.register_fleet(self)

    # -- reader side (records only; decisions are taken at clock edges) ----

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(sock,), daemon=True,
                             name="fleet-reader").start()

    def _reader(self, sock: socket.socket) -> None:
        worker = None
        try:
            hello = transport.recv_msg(sock)
            if hello.get("kind") != "hello":
                sock.close()
                return
            worker = int(hello["worker"])
            with self._lock:
                self._socks[worker] = sock
                self.membership.add(worker, hello.get("pid"))
            self._emit("worker_up", worker=worker, attrs={"pid": hello.get("pid")})
            while True:
                msg = transport.recv_msg(sock)
                self.membership.beat(worker)
                if msg.get("kind") == "pong":
                    continue
                self._inbox.append((worker, msg))
        except (transport.TransportClosed, OSError, ValueError):
            if worker is not None:
                self._inbox.append((worker, {"kind": "eof"}))

    # -- the queue-like API ------------------------------------------------

    def submit(self, req: Request) -> FleetTicket:
        """Accept one request: a durable ticket, dispatched to its bucket's
        worker. Submission is a clock edge (the inbox and the heartbeats
        are processed first). A dispatch that exhausts every attempt fails
        the ticket with the cause AND raises it, as
        :meth:`..serve.queue.Queue.submit` does."""
        with self._lock:
            self._process(self.clock())
            seq = next(self._seq)
            if req.rid is None:
                req.rid = seq
            ticket = FleetTicket(req, seq, self.clock())
            self._tickets[seq] = ticket
            try:
                self._dispatch(ticket, "route")
            except Exception as e:
                ticket.error = e
                del self._tickets[seq]
                raise
            return ticket

    def poll(self) -> None:
        """The router clock edge: apply acknowledgements, read heartbeat
        timeouts against the injected clock, send due pings, re-dispatch
        the tickets of workers that just died or went silent."""
        with self._lock:
            self._process(self.clock())

    def flush(self) -> None:
        """Make every worker dispatch its partial batches (end of a stream,
        or a latency flush)."""
        with self._lock:
            self._process(self.clock())
            for worker in self.membership.routable():
                self._send(worker, {"kind": "flush"})

    def join(self, tickets, timeout_s: float = 60.0, poll_s: float = 0.005) -> bool:
        """Drive clock edges until every ticket resolves (result or error);
        False on a wall-clock timeout. The wait's budget is REAL wall
        time: the injected clock is the protocol's, not a scheduler."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            if all(t.resolved() for t in tickets):
                return True
            if time.monotonic() >= deadline:
                return False
            self.poll()
            time.sleep(poll_s)

    def drain_fleet(self, timeout_s: float = 30.0) -> None:
        """Drain every worker gracefully (handbacks re-route until no
        routable worker is left): the router's own shutdown."""
        with self._lock:
            self._process(self.clock())
            for worker in self.membership.routable():
                self._send(worker, {"kind": "drain"})
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            self.poll()
            if not self.membership.routable():
                return
            time.sleep(0.01)

    def close(self) -> None:
        # shutdown() before close(): a reader thread blocked in recv holds
        # the open file description, so close() alone sends no FIN and the
        # accept loop and every worker would block for good (and the
        # workers' queues would stay on /healthz); shutdown() wakes them
        self._closing = True
        with self._lock:
            socks = [self._listener] + list(self._socks.values())
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- health -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": self.membership.states(),
                "unresolved": len(self._tickets),
                "redispatches": self.redispatches,
                "handbacks": self.handbacks,
                "lost": self.lost,
                "failover": self.failover,
                "breakers": {w: _circuit.peek(worker_site(w))
                             for w in self.membership.states()},
            }

    def fleet_view(self) -> dict:
        """The router's own fleet section of ``/healthz`` (no fan-out to
        the workers: the scrape thread must never block on a wedged
        worker)."""
        return self.stats()

    def healthz(self, timeout_s: float = 5.0) -> dict:
        """One fleet view: the router's stats plus each routable worker's
        own ``/healthz`` payload, fetched over the protocol (a worker that
        does not answer within ``timeout_s`` is reported as a string).
        ``status`` is ``ok`` only when every registered worker is up and
        answered."""
        with self._lock:
            self._process(self.clock())
            targets = self.membership.routable()
            for worker in targets:
                self._replies.pop((worker, "healthz"), None)
                self._send(worker, {"kind": "healthz"})
        payloads = self._gather(targets, "healthz", timeout_s,
                                lambda msg: msg.get("payload"))
        states = self.membership.states()
        ok = (states and all(m["state"] == "up" for m in states.values())
              and len(payloads) == len(targets))
        return {"status": "ok" if ok else "degraded", "fleet": self.stats(),
                "workers": {w: payloads.get(w, "no healthz reply") for w in targets}}

    def warmup(self, specs, timeout_s: float = 120.0) -> dict:
        """Send ``warmup`` (the ProgramSpecs' wire forms) to every routable
        worker and wait for the acknowledgements; returns ``{worker: first
        warm-call seconds}`` (a worker missing: no acknowledgement in
        time)."""
        wire = [s.to_wire() for s in specs]
        with self._lock:
            self._process(self.clock())
            targets = self.membership.routable()
            for worker in targets:
                self._replies.pop((worker, "warmed"), None)
                self._send(worker, {"kind": "warmup", "specs": wire})
        return self._gather(targets, "warmed", timeout_s,
                            lambda msg: float(msg.get("compile_s", 0.0)))

    def _gather(self, targets, kind: str, timeout_s: float, value) -> dict:
        """Poll until each of ``targets`` replied ``kind`` or ``timeout_s``
        passed; ``{worker: value(reply)}``."""
        got = {}
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline and len(got) < len(targets):
            self.poll()
            with self._lock:
                for worker in targets:
                    msg = self._replies.pop((worker, kind), None)
                    if msg is not None:
                        got[worker] = value(msg)
            time.sleep(0.005)
        return got

    # -- clock-edge processing ---------------------------------------------

    def _process(self, now: float) -> None:
        while self._inbox:
            worker, msg = self._inbox.popleft()
            kind = msg.get("kind")
            if kind == "result":
                self._apply_result(worker, msg)
            elif kind == "draining":
                self.membership.mark_draining(worker)
                self._emit("draining", worker=worker)
            elif kind == "drained":
                self._apply_drained(worker, msg)
            elif kind == "eof":
                self._on_worker_down(worker, "eof")
            elif kind in ("healthz", "warmed"):
                self._replies[(worker, kind)] = msg
        for worker in self.membership.timed_out(now):
            self._on_heartbeat_timeout(worker)
        if now - self._last_ping >= self.heartbeat_s:
            self._last_ping = now
            for worker in self.membership.routable():
                self._send(worker, {"kind": "ping"})

    def _apply_result(self, worker: int, msg: dict) -> None:
        seq = int(msg["seq"])
        self._assigned.get(worker, set()).discard(seq)
        ticket = self._tickets.pop(seq, None)
        if ticket is None:
            return              # a late duplicate of a re-dispatched ticket
        if msg.get("ok"):
            arrays = [array_from_wire(d) for d in msg.get("arrays", [])]
            ticket._result = arrays[0] if len(arrays) == 1 else tuple(arrays)
            ticket.info = msg.get("info")
            ticket.queue_s = msg.get("queue_s")
            ticket.total_s = msg.get("total_s")
            ticket.done = True
            _circuit.breaker(worker_site(worker), clock=self.clock).record_success()
        else:
            err = msg.get("error") or {}
            ticket.error = RemoteError(worker, err.get("type", "Exception"),
                                       err.get("message", ""))

    def _apply_drained(self, worker: int, msg: dict) -> None:
        handback = [int(s) for s in msg.get("handback", [])]
        self.membership.mark_dead(worker, "drained")
        self._emit("drained", worker=worker, attrs={"handback": len(handback)})
        self._emit("worker_dead", worker=worker, attrs={"reason": "drained"})
        self._assigned.pop(worker, None)
        for seq in handback:
            ticket = self._tickets.get(seq)
            if ticket is None or ticket.resolved():
                continue
            self.handbacks += 1
            try:
                self._dispatch(ticket, "handback", previous=worker)
            except Exception as e:
                ticket.error = e
                self._tickets.pop(seq, None)

    def _on_heartbeat_timeout(self, worker: int) -> None:
        """An ``up`` worker went silent past the timeout: force its breaker
        open (readmission is the half-open probe), re-dispatch its
        unacknowledged tickets, trip the flight recorder. The worker may
        still be alive: the at-least-once semantics cover the overlap."""
        self._emit("heartbeat_timeout", worker=worker,
                   attrs={"timeout_s": self.membership.heartbeat_timeout_s})
        br = _circuit.breaker(worker_site(worker), clock=self.clock)
        while br.state() != "open":
            br.record_failure()
        self._reap(worker, "heartbeat_timeout")

    def _on_worker_down(self, worker: int, reason: str) -> None:
        already_dead = self.membership.state(worker) == "dead"
        self.membership.mark_dead(worker, reason)
        with self._lock:
            sock = self._socks.pop(worker, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if not already_dead:
            self._emit("worker_dead", worker=worker, attrs={"reason": reason})
        self._reap(worker, reason)

    def _reap(self, worker: int, reason: str) -> None:
        """Settle ``worker``'s unacknowledged tickets: re-dispatch them
        (failover) or fail them with ``ticket_lost`` records, which the
        validator rejects. Either way the flight recorder dumps with the
        decision in its ring."""
        seqs = sorted(self._assigned.pop(worker, set()))
        live = [s for s in seqs if s in self._tickets and not self._tickets[s].resolved()]
        flight.trigger("fleet_worker_down", worker=worker, cause=reason, unacked=len(live),
                       failover=self.failover)
        for seq in live:
            ticket = self._tickets[seq]
            if self.failover:
                self.redispatches += 1
                ticket.redispatched += 1
                try:
                    self._dispatch(ticket, "redispatch", previous=worker)
                except Exception as e:
                    ticket.error = e
                    self._tickets.pop(seq, None)
            else:
                self.lost += 1
                ticket.error = WorkerLostError(worker, seq, reason)
                self._tickets.pop(seq, None)
                with obs.trace_context(trace_id=ticket.trace_id):
                    self._emit("ticket_lost", worker=worker, seq=seq,
                               attrs={"reason": reason, "rid": ticket.request.rid})

    # -- dispatch ----------------------------------------------------------

    def _candidates(self, ticket: FleetTicket) -> list:
        """The routable workers in the ticket's bucket order: the CRC32 of
        its bucket string indexes the sorted routable list, so one
        bucket's tickets co-locate while distinct buckets spread."""
        workers = self.membership.routable()
        if not workers:
            return []
        start = zlib.crc32(ticket.bucket.encode()) % len(workers)
        return workers[start:] + workers[:start]

    def _select(self, ticket: FleetTicket):
        """The first candidate whose breaker admits the call (an open one
        is skipped; one whose cooldown elapsed admits THIS dispatch as its
        half-open probe); none admits: fail fast. ``(worker, probed)``."""
        for worker in self._candidates(ticket):
            br = _circuit.breaker(worker_site(worker), clock=self.clock)
            was = br.state()
            try:
                br.allow()
            except Exception:
                continue
            return worker, was != "closed"
        raise FleetUnavailableError(
            len(self.membership.states()),
            {w: m["state"] for w, m in self.membership.states().items()})

    def _dispatch(self, ticket: FleetTicket, event: str,
                  previous: Optional[int] = None) -> None:
        """Send one ticket under the retry policy, the worker chosen at
        each attempt: a transient fault retries into the same (still
        admitted) worker; a sustained one opens that worker's breaker
        within the policy and the next attempt goes to a sibling."""
        from ..health import inject

        policy = RetryPolicy(max_attempts=self.retry_attempts,
                             backoff_base_s=self.retry_backoff_s)
        msg = {"kind": "submit", "seq": ticket.seq, "req": ticket.wire,
               "trace_id": ticket.trace_id}

        def _attempt():
            worker, probed = self._select(ticket)
            br = _circuit.breaker(worker_site(worker), clock=self.clock)
            try:
                inject.maybe_fail_fleet_dispatch()
                self._send_raw(worker, msg)
            except Exception:
                br.record_failure()
                raise
            return worker, probed

        worker, probed = with_policy(DISPATCH_SITE, _attempt, policy=policy, clock=self.clock)
        ticket.worker = worker
        ticket.attempts.append(worker)
        self._assigned.setdefault(worker, set()).add(ticket.seq)
        attrs = {"bucket": ticket.bucket, "rid": ticket.request.rid}
        if previous is not None:
            attrs["from"] = previous
        with obs.trace_context(trace_id=ticket.trace_id):
            self._emit(event, worker=worker, seq=ticket.seq, attrs=attrs)
            if probed:
                self._emit("probe", worker=worker, seq=ticket.seq,
                           attrs={"bucket": ticket.bucket})

    def _send(self, worker: int, msg: dict) -> None:
        """Best-effort control message: a dead socket goes down the EOF
        path instead of raising into the caller."""
        try:
            self._send_raw(worker, msg)
        except (OSError, KeyError):
            self._inbox.append((worker, {"kind": "eof"}))

    def _send_raw(self, worker: int, msg: dict) -> None:
        with self._lock:
            sock = self._socks.get(worker)
        if sock is None:
            raise ConnectionError(f"fleet worker {worker} has no live connection")
        transport.send_msg(sock, msg)

    # -- records -----------------------------------------------------------

    def _emit(self, event: str, *, worker: int, seq: Optional[int] = None,
              attrs: Optional[dict] = None) -> None:
        payload = {"event": event, "worker": int(worker), "attrs": attrs or {}}
        if seq is not None:
            payload["seq"] = int(seq)
        obs.emit_event("fleet", **payload)
        if obs.metrics_active():
            obs.counter("dlaf_fleet_events_total", event=event).inc()
