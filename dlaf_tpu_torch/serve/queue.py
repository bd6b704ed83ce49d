"""Request-queue front end over the bucketed program service.

Port of ``dlaf_tpu/serve/queue.py`` (docs/serving.md). :class:`Queue`
accepts singleton requests (one ``(n, n)`` problem each, a host array),
buckets them by ``(op, dtype, uplo/side/op/diag, bucket ceiling)``, pads
each problem to the bucket ceiling, dispatches the warm bucket program when
a batch fills (or when the oldest pending request is past the
``serve_deadline_ms`` deadline) and unpads the results to request shape.

Determinism contract: the queue runs NO background thread. Deadlines are
read against the injected ``clock`` at ``submit``/``poll``/``flush``, so
which requests share a dispatch is a pure function of the submission
sequence and the clock values, the same as the reference's.

Padding contract:

* lane padding (a dispatch that is not full): the missing lanes are
  identity matrices (zero right-hand sides); lanes are independent
  (:mod:`..algorithms.batched`), so the real lanes' results are the same
  at every occupancy;
* shape padding (``n_req < bucket n``): the problem is embedded in an
  identity border (``[[A, 0], [0, I]]``, zero rhs rows/columns; the eigh
  border is ``c*I`` with ``c`` above the Gershgorin bound of the stored
  triangle's Hermitian expansion, so the pad eigenvalues sort last). The
  padded region stays exactly identity/zero; the real block is within a
  few ulp of the exact-size program, not bitwise.

The batch is composed on the host and each operand moved to the service's
device in one copy per dispatch attempt; the results come back in one
copy per output, and each ticket's result is a view of them.

Resilience: an admission bound (``serve_max_depth``, shed or
backpressure by ``serve_shed``), per-request deadlines
(``Request.deadline_s``, cancelled at dispatch composition), and each
dispatch retried under :mod:`..health.policy` behind a per-bucket circuit
breaker (:mod:`..health.circuit`). :meth:`Queue.stats` snapshots the
per-bucket depth, shed, expired and breaker states.

Records (:mod:`..obs`), as the reference's (``queue.py:458-900``):
``submit`` stamps one ``trace_id`` per request (``Ticket.trace_id``, drawn
or adopted from the caller) and
each dispatch draws one ``span_id`` and runs under a batch-scope
``obs.trace_context`` (the members' trace IDs and the span ID), so every
record of the dispatch (its retry and breaker records included) joins to
its requests. Counters ``dlaf_serve_requests_total``,
``dlaf_serve_dispatch_total``, ``dlaf_serve_shed_total``,
``dlaf_serve_drained_total`` and ``dlaf_deadline_exceeded_total``, the
``dlaf_serve_depth`` gauge, the ``serve.dispatch`` span and the
``dlaf_serve_dispatch_seconds`` histogram; a ``serve`` dispatch record
with its stage walls and a ``serve`` request record plus a
``serve.request`` span per request; ``resilience`` records of each shed,
expiry and drain; each request's latency into ``obs.observe_latency``.
A queue registers itself with the ``/healthz`` exporter at construction,
and an admission shed trips the flight recorder.

Each dispatch attempt consults ``health.inject.maybe_fail_dispatch``
inside the retried attempt, as the reference's does, so the dispatch-fault
drill (``inject.fail_dispatch``) meets the policy's retries and the
bucket's breaker.

Under ``DLAF_ACCURACY`` (with metrics on) each request also gets an
``accuracy`` record of site ``serve`` with its lane's exact residual
(:func:`_residuals`, the reference's ``_residual_prog``), through
:func:`..obs.accuracy.emit`.

Autotune steering (reference ``queue.py:392, 674-680, 737, 778,
909-935``; :mod:`..autotune`): each bucket consults the same route table
as the algorithm entries (serve op -> table op: ``cholesky`` ->
``cholesky``, ``solve`` -> ``trsm``, ``eigh`` -> ``eigensolver``), its
spec carrying the route, so a learned route change dispatches a new bucket
program. Under ``DLAF_ACCURACY`` each dispatch's WORST real-lane residual
feeds the bucket's entry, one decision per dispatch, after the dispatch's
bookkeeping: a strict ``AutotuneExhaustedError`` surfaces to the caller
but the dispatch itself succeeded (tickets fulfilled, counted as a
dispatch, not a failure).
"""

from __future__ import annotations

import base64
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import obs
from ..common.asserts import dlaf_assert
from ..obs import accuracy as obs_accuracy
from ..config import get_configuration, parse_serve_buckets
from ..health import circuit as _circuit
from ..health import inject
from ..health.errors import DeadlineExceededError, DrainedError, OverloadError
from ..health.policy import RetryPolicy, with_policy
from .programs import ProgramService, cholesky_spec, eigh_spec, get_service, solve_spec

#: ops the queue serves
OPS = ("cholesky", "solve", "eigh")


def resolve_buckets() -> tuple:
    """The configured explicit ceilings (empty = the power-of-two policy)."""
    return parse_serve_buckets(get_configuration().serve_buckets)


def bucket_ceiling(n: int, buckets: tuple = None) -> int:
    """The smallest configured bucket >= n, else (none fits, or no list)
    the next power of two >= max(n, 8): every shape is servable."""
    n = int(n)
    dlaf_assert(n >= 1, f"bucket_ceiling: n must be >= 1, got {n}")
    if buckets is None:
        buckets = resolve_buckets()
    for b in buckets:
        if b >= n:
            return b
    return 1 << max(int(n) - 1, 7).bit_length()


def rhs_ceiling(free: int) -> int:
    """Ceiling of the solve's rhs free-axis width: the next power of two
    >= free (not the matrix buckets, which would multiply a 1-column rhs
    by the bucket order)."""
    free = int(free)
    dlaf_assert(free >= 1, f"rhs_ceiling: free must be >= 1, got {free}")
    return 1 << (free - 1).bit_length()


# ---------------------------------------------------------------------------
# Wire codec: a request crosses a process boundary as JSON, arrays as
# base64 of their raw bytes with dtype and shape (exact).
# ---------------------------------------------------------------------------

def array_to_wire(a) -> dict:
    """One array as a JSON-safe dict (dtype name, shape, base64 of the
    C-contiguous raw bytes)."""
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": a.dtype.name, "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def array_from_wire(doc: dict) -> np.ndarray:
    """Inverse of :func:`array_to_wire` (a writable copy)."""
    flat = np.frombuffer(base64.b64decode(doc["data"]), dtype=np.dtype(doc["dtype"]))
    return flat.reshape(tuple(int(s) for s in doc["shape"])).copy()


@dataclasses.dataclass
class Request:
    """One serving request: ``op`` in :data:`OPS`, ``a`` the ``(n, n)``
    problem (a host array; triangle semantics per op), ``b`` the solve's
    rhs (``(n, nrhs)`` side 'L', ``(nrhs, n)`` side 'R'), ``alpha`` the
    solve scale. ``rid`` is stamped by the queue when None.
    ``deadline_s`` (None = none) bounds the queue wait: a request still
    pending that long after submit is cancelled at dispatch composition
    with a :class:`..health.errors.DeadlineExceededError` cause."""

    op: str
    a: Any
    b: Any = None
    uplo: str = "L"
    side: str = "L"
    transa: str = "N"
    diag: str = "N"
    alpha: float = 1.0
    rid: Optional[int] = None
    deadline_s: Optional[float] = None

    def to_wire(self) -> dict:
        """JSON-safe form; round-trips exactly through :meth:`from_wire`."""
        return {"op": self.op, "a": array_to_wire(self.a),
                "b": None if self.b is None else array_to_wire(self.b),
                "uplo": self.uplo, "side": self.side, "transa": self.transa,
                "diag": self.diag, "alpha": float(self.alpha), "rid": self.rid,
                "deadline_s": self.deadline_s}

    @classmethod
    def from_wire(cls, doc: dict) -> "Request":
        return cls(op=str(doc["op"]), a=array_from_wire(doc["a"]),
                   b=None if doc.get("b") is None else array_from_wire(doc["b"]),
                   uplo=str(doc.get("uplo", "L")), side=str(doc.get("side", "L")),
                   transa=str(doc.get("transa", "N")), diag=str(doc.get("diag", "N")),
                   alpha=float(doc.get("alpha", 1.0)), rid=doc.get("rid"),
                   deadline_s=doc.get("deadline_s"))


class Ticket:
    """Handle returned by :meth:`Queue.submit`. ``done`` flips when the
    request's batch dispatched; :meth:`result` returns the unpadded
    per-request output as host (numpy) arrays and raises RuntimeError
    while still queued. ``info`` is the request's info value once done.
    ``trace_id`` (16 hex characters, or the one the submitter passed)
    joins every record of the request's chain."""

    def __init__(self, request: Request, submitted: float, trace_id: Optional[str] = None):
        self.request = request
        # an adopted ID (the fleet worker passes its router ticket's) keeps
        # the cross-process chain joinable from either side
        self.trace_id = trace_id or obs.new_trace_id()
        self.submitted = submitted
        self.done = False
        self.error: Optional[BaseException] = None
        self.info: Optional[int] = None
        self.queue_s: Optional[float] = None
        self.total_s: Optional[float] = None
        self._result = None

    def result(self):
        if self.error is not None:
            what = ("expired before dispatch" if isinstance(self.error, DeadlineExceededError)
                    else "drained undispatched" if isinstance(self.error, DrainedError)
                    else "batch dispatch failed")
            raise RuntimeError(f"request {self.request.rid}: {what} "
                               f"({type(self.error).__name__})") from self.error
        if not self.done:
            raise RuntimeError(f"request {self.request.rid} is still queued; Queue.flush() "
                               "forces dispatch of partial batches")
        return self._result


@dataclasses.dataclass(frozen=True)
class _BucketKey:
    op: str
    n: int            # bucket ceiling
    nrhs: int         # rhs ceiling (0 for non-solve)
    dtype: str
    uplo: str
    side: str
    transa: str
    diag: str


# ---------------------------------------------------------------------------
# Padding / unpadding (host side: request shapes are small)
# ---------------------------------------------------------------------------

def _pad_a(req: Request, bn: int) -> np.ndarray:
    a = np.asarray(req.a)
    n = a.shape[0]
    if n == bn:
        return a
    out = np.zeros((bn, bn), a.dtype)
    out[:n, :n] = a
    if req.op == "eigh":
        # the pad eigenvalues must sort after every real one: c above the
        # Gershgorin (inf-norm) bound of the stored triangle's Hermitian
        # expansion, which bounds the spectral radius (max|A| does not)
        tri = np.tril(a) if req.uplo == "L" else np.triu(a)
        k = -1 if req.uplo == "L" else 1
        herm = tri + np.conj(np.tril(tri, k) if req.uplo == "L" else np.triu(tri, k)).T
        c = 1.0 + float(np.abs(herm).sum(axis=1).max(initial=0.0))
    else:
        c = 1.0
    out[range(n, bn), range(n, bn)] = c
    return out


def _pad_b(req: Request, bn: int, brhs: int) -> np.ndarray:
    b = np.asarray(req.b)
    shape = (bn, brhs) if req.side == "L" else (brhs, bn)
    if b.shape == shape:
        return b
    out = np.zeros(shape, b.dtype)
    out[:b.shape[0], :b.shape[1]] = b
    return out


def _pad_lane(key: _BucketKey):
    """The inert pad-lane operands of one unfilled batch slot."""
    dt = np.dtype(key.dtype)
    a = np.eye(key.n, dtype=dt)
    if key.op != "solve":
        return (a,)
    shape = (key.n, key.nrhs) if key.side == "L" else (key.nrhs, key.n)
    return a, np.zeros(shape, dt)


def _unpad(req: Request, key: _BucketKey, lane_out):
    """One lane's bucket-shaped outputs cut back to request shape."""
    n = np.asarray(req.a).shape[0]
    if req.op == "cholesky":
        return lane_out[:n, :n]
    if req.op == "solve":
        rows, cols = np.asarray(req.b).shape
        return lane_out[:rows, :cols]
    w, v = lane_out
    return w[:n], v[:n, :n]


# ---------------------------------------------------------------------------
# The queue
# ---------------------------------------------------------------------------

class Queue:
    """Bucketing, padding and deadline front end (module docstring).

    ``batch``/``deadline_s``/``buckets`` default to the ``serve_batch``/
    ``serve_deadline_ms``/``serve_buckets`` knobs; ``clock`` (default
    ``time.monotonic``) is injectable so deadline behavior is
    deterministic under test. The programs run on the service's device."""

    def __init__(self, service: Optional[ProgramService] = None, *,
                 batch: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 buckets: Optional[tuple] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_depth: Optional[int] = None,
                 shed: Optional[bool] = None,
                 retry_attempts: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None):
        cfg = get_configuration()
        self.service = service if service is not None else get_service()
        self.batch = int(batch if batch is not None else cfg.serve_batch)
        dlaf_assert(self.batch >= 1, f"Queue: batch must be >= 1, got {self.batch}")
        self.deadline_s = float(cfg.serve_deadline_ms / 1e3 if deadline_s is None
                                else deadline_s)
        self.buckets = tuple(buckets) if buckets is not None else resolve_buckets()
        self.clock = clock
        self.max_depth = int(max_depth if max_depth is not None else cfg.serve_max_depth)
        dlaf_assert(self.max_depth >= 0, f"Queue: max_depth must be >= 0, got {self.max_depth}")
        self.shed = bool(cfg.serve_shed if shed is None else shed)
        self.retry_attempts = int(retry_attempts if retry_attempts is not None
                                  else cfg.serve_retry_attempts)
        dlaf_assert(self.retry_attempts >= 1,
                    f"Queue: retry_attempts must be >= 1, got {self.retry_attempts}")
        self.retry_backoff_s = float(cfg.serve_retry_backoff_ms / 1e3 if retry_backoff_s is None
                                     else retry_backoff_s)
        self._pending: dict = {}          # _BucketKey -> [(req, ticket)]
        self._rid = itertools.count()
        # one lock over submit/poll/flush: bucket fill and pop must be
        # atomic, or two request threads filling one bucket double-pop it
        self._lock = threading.RLock()
        self.dispatches = 0
        self.requests = 0
        self._in_flight = 0               # dispatches currently executing
        self._counts: dict = {}           # _BucketKey -> per-bucket counts
        obs.exporter.register_queue(self)

    # -- submission ------------------------------------------------------

    def _key(self, req: Request) -> _BucketKey:
        a = np.asarray(req.a)
        dlaf_assert(req.op in OPS, f"Queue: op must be one of {OPS}, got {req.op!r}")
        dlaf_assert(a.ndim == 2 and a.shape[0] == a.shape[1],
                    f"Queue: request 'a' must be square (n, n), got {a.shape}")
        bn = bucket_ceiling(a.shape[0], self.buckets)
        nrhs = 0
        if req.op == "solve":
            b = np.asarray(req.b)
            dlaf_assert(b.ndim == 2, "Queue: solve request needs a 2D rhs")
            dlaf_assert(b.dtype == a.dtype,
                        f"Queue: rhs dtype {b.dtype} != matrix dtype {a.dtype} (one bucket "
                        "program serves one dtype)")
            solve_dim, free = ((b.shape[0], b.shape[1]) if req.side == "L"
                               else (b.shape[1], b.shape[0]))
            dlaf_assert(solve_dim == a.shape[0],
                        f"Queue: rhs solve dimension {solve_dim} != n={a.shape[0]}")
            nrhs = rhs_ceiling(free)
        return _BucketKey(op=req.op, n=bn, nrhs=nrhs, dtype=np.dtype(a.dtype).name,
                          uplo=req.uplo, side=req.side, transa=req.transa, diag=req.diag)

    def _bucket_counts(self, key: _BucketKey) -> dict:
        return self._counts.setdefault(key, {"shed": 0, "expired": 0, "dispatches": 0,
                                             "failures": 0, "drained": 0})

    def _admit(self, key: _BucketKey) -> None:
        """Admission control (lock held): at the ``max_depth`` bound, shed
        this submit with OverloadError, or (shed off) dispatch the fullest
        bucket inline until there is room. Depth never exceeds
        ``max_depth``."""
        if not self.max_depth:
            return
        while self.pending() >= self.max_depth:
            if self.shed:
                self._bucket_counts(key)["shed"] += 1
                obs.counter("dlaf_serve_shed_total", op=key.op, bucket_n=key.n).inc()
                obs.emit_event("resilience", site="serve.queue", event="shed",
                               attrs={"op": key.op, "bucket_n": key.n,
                                      "depth": self.pending(), "max_depth": self.max_depth})
                # a shed burst is an incident: the recorder's cooldown
                # dumps the ring at the first shed only
                obs.flight.trigger("overload_shed", op=key.op, bucket_n=key.n,
                                   depth=self.pending(), max_depth=self.max_depth)
                raise OverloadError(self.pending(), self.max_depth, op=key.op, bucket_n=key.n)
            fullest = max((k for k, v in self._pending.items() if v),
                          key=lambda k: len(self._pending[k]), default=None)
            if fullest is None:
                return          # nothing pending: the bound cannot bind
            try:
                self._dispatch(fullest)
            except Exception:
                # the inline dispatch failed for ANOTHER bucket's batch: its
                # tickets carry the cause and its lanes were popped, so room
                # was made; this submit is still admitted
                pass

    def submit(self, req: Request, trace_id: Optional[str] = None) -> Ticket:
        """Enqueue one request; dispatch its bucket when the batch fills,
        and dispatch OTHER buckets past their deadline (submission is a
        clock edge). At the ``max_depth`` bound the submit sheds
        (:class:`..health.errors.OverloadError`, no ticket created) or
        applies backpressure, by ``shed``. ``trace_id`` (optional) makes
        the ticket adopt an existing trace: the fleet worker passes its
        router ticket's, so the chain across processes joins on one ID."""
        with self._lock:
            now = self.clock()
            key = self._key(req)          # validate BEFORE admission
            self._admit(key)
            if req.rid is None:
                req.rid = next(self._rid)
            ticket = Ticket(req, now, trace_id)
            lanes = self._pending.setdefault(key, [])
            lanes.append((req, ticket))
            self.requests += 1
            if obs.metrics_active():
                obs.counter("dlaf_serve_requests_total", op=req.op).inc()
                obs.gauge("dlaf_serve_depth", op=key.op, bucket_n=key.n).set(float(len(lanes)))
            if len(lanes) >= self.batch:
                self._dispatch(key)
            self.poll(now)
            return ticket

    def poll(self, now: Optional[float] = None) -> int:
        """Dispatch every bucket whose OLDEST pending request is past the
        deadline; returns the number of dispatches."""
        with self._lock:
            now = self.clock() if now is None else now
            n = 0
            for key in [k for k, lanes in self._pending.items()
                        if lanes and now - lanes[0][1].submitted >= self.deadline_s]:
                self._dispatch(key)
                n += 1
            return n

    def flush(self) -> int:
        """Dispatch every pending bucket regardless of fill or deadline;
        returns the number of dispatches."""
        with self._lock:
            n = 0
            for key in [k for k, lanes in self._pending.items() if lanes]:
                self._dispatch(key)
                n += 1
            return n

    def drain(self) -> list:
        """Cancel every UNDISPATCHED request (graceful shutdown) and return
        the ``(request, ticket)`` pairs in submission order per bucket;
        each ticket carries a :class:`..health.errors.DrainedError`."""
        with self._lock:
            drained = []
            for key in [k for k, lanes in self._pending.items() if lanes]:
                lanes = self._pending.pop(key)
                counts = self._bucket_counts(key)
                obs.gauge("dlaf_serve_depth", op=key.op, bucket_n=key.n).set(0.0)
                for req, ticket in lanes:
                    ticket.error = DrainedError("serve.queue", req.rid, op=key.op,
                                                bucket_n=key.n)
                    counts["drained"] += 1
                    obs.counter("dlaf_serve_drained_total", op=key.op).inc()
                    with obs.trace_context(trace_id=ticket.trace_id):
                        obs.emit_event("resilience", site="serve.queue", event="drain",
                                       attrs={"rid": req.rid, "op": key.op,
                                              "bucket_n": key.n})
                    drained.append((req, ticket))
            return drained

    def pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def stats(self) -> dict:
        """Totals (pending depth, in-flight dispatches, requests,
        dispatches, shed/expired/drained, the admission config) and a
        per-bucket table keyed by the bucket program's site: depth, shed,
        expired, dispatches, failures, drained and the breaker's state
        (None = the bucket never dispatched)."""
        with self._lock:
            buckets = {}
            for key in set(self._pending) | set(self._counts):
                counts = self._counts.get(key) or {}
                site = self._spec(key).site
                buckets[site] = {
                    "depth": len(self._pending.get(key, [])),
                    "shed": counts.get("shed", 0),
                    "expired": counts.get("expired", 0),
                    "dispatches": counts.get("dispatches", 0),
                    "failures": counts.get("failures", 0),
                    "drained": counts.get("drained", 0),
                    "breaker": _circuit.peek(site),
                }
            return {
                "pending": self.pending(),
                "in_flight": self._in_flight,
                "requests": self.requests,
                "dispatches": self.dispatches,
                "shed": sum(b["shed"] for b in buckets.values()),
                "expired": sum(b["expired"] for b in buckets.values()),
                "drained": sum(b["drained"] for b in buckets.values()),
                "max_depth": self.max_depth,
                "shed_policy": "shed" if self.shed else "backpressure",
                "buckets": buckets,
            }

    # -- warmup ----------------------------------------------------------

    def _steering(self, key: _BucketKey):
        """The bucket's autotune steering handle (None: the loop is
        closed for it), against the table the algorithm entries learn."""
        from .. import autotune

        return autotune.steering(_AUTOTUNE_OP[key.op], n=key.n, nb=_default_nb(key.n),
                                 dtype=key.dtype, platform=self.service.device.type)

    def _spec(self, key: _BucketKey):
        nb = _default_nb(key.n)
        steer = self._steering(key)
        route = steer.route.key() if steer is not None else ()
        if key.op == "cholesky":
            return cholesky_spec(batch=self.batch, n=key.n, nb=nb, dtype=key.dtype,
                                 uplo=key.uplo, with_info=True, donate=True, route=route)
        if key.op == "solve":
            return solve_spec(batch=self.batch, n=key.n, nrhs=key.nrhs, nb=nb,
                              dtype=key.dtype, side=key.side, uplo=key.uplo,
                              transa=key.transa, diag=key.diag, with_info=True, donate=True,
                              route=route)
        return eigh_spec(batch=self.batch, n=key.n, nb=nb, dtype=key.dtype, uplo=key.uplo,
                         with_info=True, donate=True, route=route)

    def warmup_specs(self, requests) -> tuple:
        """The exact ProgramSpecs a stream of ``requests`` dispatches
        through: ``service.warmup(*queue.warmup_specs(sample))`` warms the
        buckets the stream hits."""
        return tuple({self._spec(self._key(r)): None for r in requests})

    def warmup(self, requests) -> dict:
        return self.service.warmup(*self.warmup_specs(requests))

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, key: _BucketKey) -> None:
        lanes = self._pending.pop(key)
        obs.gauge("dlaf_serve_depth", op=key.op, bucket_n=key.n).set(0.0)
        self._in_flight += 1
        try:
            ran, observe = self._dispatch_lanes(key, lanes)
            if ran:
                self._bucket_counts(key)["dispatches"] += 1
        except Exception as e:
            self._bucket_counts(key)["failures"] += 1
            # a failed dispatch (OOM, exhausted retries, open breaker, ...)
            # must not strand its tickets as queued forever: poison them
            # with the cause (result() re-raises it) and let the exception
            # reach the caller; expired tickets keep their own cause
            for _, ticket in lanes:
                if ticket.error is None and not ticket.done:
                    ticket.error = e
            raise
        finally:
            self._in_flight -= 1
        if observe is not None:
            # after the bookkeeping: the batch completed and its tickets are
            # fulfilled, so a strict exhaustion raise here is an accuracy
            # incident, never a dispatch failure
            observe()

    def _expire_lanes(self, key: _BucketKey, lanes: list, now: float) -> list:
        """Cancel requests whose queue wait exceeded their deadline; returns
        the live lanes."""
        live = []
        for req, ticket in lanes:
            waited = now - ticket.submitted
            if req.deadline_s is not None and waited > req.deadline_s:
                ticket.error = DeadlineExceededError("serve.queue", waited, req.deadline_s)
                self._bucket_counts(key)["expired"] += 1
                obs.counter("dlaf_deadline_exceeded_total", site="serve.queue").inc()
                with obs.trace_context(trace_id=ticket.trace_id):
                    obs.emit_event("resilience", site="serve.queue", event="expired",
                                   attrs={"rid": req.rid, "op": key.op, "bucket_n": key.n,
                                          "waited_s": float(waited),
                                          "deadline_s": float(req.deadline_s)})
            else:
                live.append((req, ticket))
        return live

    def _dispatch_lanes(self, key: _BucketKey, lanes: list):
        """Compose, run and unpad one batch; returns ``(ran, observe)``:
        False when every lane expired (no program ran, and it counts as no
        dispatch), and the deferred autotune feedback (None when the loop
        is closed), which :meth:`_dispatch` runs after its bookkeeping."""
        lanes = self._expire_lanes(key, lanes, self.clock())
        if not lanes:
            return False, None
        reqs = [r for r, _ in lanes]
        tickets = [t for _, t in lanes]
        spec = self._spec(key)
        resident = spec in self.service.specs()
        # batch scope: the dispatch's span ID and its members' trace IDs
        # stamp every record below (the policy's retries included)
        span_id = obs.new_span_id()
        with obs.trace_context(trace_id=[t.trace_id for t in tickets], span_id=span_id):
            return True, self._dispatch_traced(key, reqs, tickets, spec, resident, span_id)

    def _dispatch_traced(self, key, reqs, tickets, spec, resident: bool, span_id: str):
        t0 = self.clock()
        pad = _pad_lane(key)
        host = [np.stack([_pad_a(r, key.n) for r in reqs] + [pad[0]] * (self.batch - len(reqs)))]
        if key.op == "solve":
            host.append(np.stack([_pad_b(r, key.n, key.nrhs) for r in reqs]
                                 + [pad[1]] * (self.batch - len(reqs))))
            one = np.dtype(key.dtype).type
            host.append(np.array([one(r.alpha) for r in reqs]
                                 + [one(1.0)] * (self.batch - len(reqs))))
        dev = self.service.device
        breaker = _circuit.breaker(spec.site, clock=self.clock)
        policy = RetryPolicy(max_attempts=self.retry_attempts, backoff_base_s=self.retry_backoff_s)

        def _attempt():
            # the dispatch-fault drill's hook, once per attempt, so the
            # policy's retries meet the fault again
            inject.maybe_fail_dispatch()
            # a fresh device copy per attempt: the program is donated the
            # batch, so a retry must not see a half-written one
            args = [torch.from_numpy(x).to(dev, copy=True) for x in host]
            return self.service.run(spec, *args)

        t_compose = self.clock()
        with obs.span("serve.dispatch", op=key.op, bucket_n=key.n, nrhs=key.nrhs,
                      lanes=len(reqs), batch=self.batch, dtype=key.dtype,
                      cache="hit" if resident else "miss"):
            out = with_policy(spec.site, _attempt, policy=policy, breaker=breaker,
                              clock=self.clock)
        t_prog = self.clock()
        outs, info = _split_outputs(key.op, out)
        # one device -> host fetch per output; per-ticket results are views
        lane_outs = tuple(o.cpu().numpy() for o in outs)
        infos = info.cpu().numpy()
        t1 = self.clock()
        for i, (req, ticket) in enumerate(zip(reqs, tickets)):
            lane = tuple(o[i] for o in lane_outs) if key.op == "eigh" else lane_outs[0][i]
            ticket._result = _unpad(req, key, lane)
            ticket.info = int(infos[i])
            ticket.queue_s = max(t0 - ticket.submitted, 0.0)
            ticket.total_s = max(t1 - ticket.submitted, 0.0)
            ticket.done = True
        t_unpad = self.clock()
        self.dispatches += 1
        if obs.metrics_active():
            obs.counter("dlaf_serve_dispatch_total", op=key.op).inc()
            obs.histogram("dlaf_serve_dispatch_seconds", op=key.op).observe(t1 - t0)
        obs.emit_event("serve", event="dispatch", op=key.op, bucket_n=key.n, nrhs=key.nrhs,
                       dtype=key.dtype, lanes=len(reqs), batch=self.batch,
                       cache="hit" if resident else "miss", dispatch_s=float(t1 - t0),
                       stages={"compose_s": float(t_compose - t0),
                               "program_s": float(t_prog - t_compose),
                               "fetch_s": float(t1 - t_prog),
                               "unpad_s": float(t_unpad - t1)})
        if not obs.metrics_active():
            return None
        residuals = None
        if obs_accuracy.enabled():
            residuals = _residuals(key, host, outs, len(reqs))
        for i, (req, ticket) in enumerate(zip(reqs, tickets)):
            n_req = int(np.asarray(req.a).shape[0])
            attrs = {"rid": req.rid, "info": ticket.info}
            # request scope: the one member's trace ID, the dispatch's span
            with obs.trace_context(trace_id=ticket.trace_id, span_id=span_id):
                obs.emit_event("serve", event="request", op=key.op, n=n_req, bucket_n=key.n,
                               dtype=key.dtype, queue_s=float(ticket.queue_s),
                               total_s=float(ticket.total_s), attrs=attrs)
                # total_s ends at the dispatch's host copy, a real fence
                obs.emit_event("span", name="serve.request", dur_s=float(ticket.total_s),
                               depth=0, parent=None,
                               attrs={"op": key.op, "n": n_req, "bucket_n": key.n, **attrs})
                obs.observe_latency(f"serve.{key.op}", ticket.total_s, bucket=str(key.n))
                if residuals is not None:
                    metric, c = _ACCURACY[key.op]
                    obs_accuracy.emit("serve", metric, residuals[i], n=n_req,
                                      nb=_default_nb(key.n), c=c, dtype=np.dtype(key.dtype),
                                      of=outs[0], attrs={"op": key.op, "rid": req.rid,
                                                         "bucket_n": key.n})
        steer = self._steering(key) if residuals is not None else None
        if steer is None:
            return None
        # the dispatch's WORST real lane feeds the bucket's table entry
        worst = float(residuals.max()) if len(residuals) else 0.0
        if not np.isfinite(residuals).all():
            worst = float("nan")
        _, c = _ACCURACY[key.op]
        member_ids = [t.trace_id for t in tickets]
        of = outs[0]

        def observe():
            # the batch's trace scope again (the deferral left it)
            with obs.trace_context(trace_id=member_ids, span_id=span_id):
                steer.observe(worst, c=c, of=of, attrs={"source": "serve", "op": key.op,
                                                       "bucket_n": key.n, "lanes": len(reqs)})
        return observe


#: op -> (accuracy metric, tolerance factor c): the reference's
#: (``queue.py:385-390``).
_ACCURACY = {"cholesky": ("cholesky_residual", 60.0),
             "solve": ("trsm_residual", 60.0),
             "eigh": ("eigen_residual", 200.0)}

#: serve op -> route-table op (the reference's ``queue.py:392``): the
#: buckets share the algorithm entries' table entries.
_AUTOTUNE_OP = {"cholesky": "cholesky", "solve": "trsm", "eigh": "eigensolver"}


def _residuals(key: _BucketKey, host: list, outs: tuple, lanes: int) -> np.ndarray:
    """The exact residual of each real lane of one dispatch (reference
    ``_residual_prog``), on the outputs' device, batched over the lanes:
    Cholesky ``|L L^H - A|_F / |A|_F``, the solve ``|op(T) X - alpha B|_F
    / |alpha B|_F``, eigh ``|A V - V diag(w)|_F / |A|_F``, each on the
    bucket-sized (padded) problem. Bucket problems are small, so the
    O(n^3) check is cheap beside the solve."""
    dev = outs[0].device
    a = torch.from_numpy(host[0][:lanes]).to(dev)
    tiny = torch.finfo(a.real.dtype if a.is_complex() else a.dtype).tiny

    def fro(x):
        return torch.sqrt(torch.sum(torch.abs(x) ** 2, dim=(-2, -1)))

    def herm(x):
        if key.uplo == "L":
            return torch.tril(x) + torch.tril(x, -1).mH
        return torch.triu(x) + torch.triu(x, 1).mH

    if key.op == "cholesky":
        ah = herm(a)
        f = outs[0][:lanes]
        tri = torch.tril(f) if key.uplo == "L" else torch.triu(f)
        ll = tri @ tri.mH if key.uplo == "L" else tri.mH @ tri
        res = fro(ll - ah) / torch.clamp(fro(ah), min=tiny)
    elif key.op == "solve":
        b = torch.from_numpy(host[1][:lanes]).to(dev)
        alpha = torch.from_numpy(host[2][:lanes]).to(dev)
        tri = torch.tril(a) if key.uplo == "L" else torch.triu(a)
        if key.diag == "U":
            eye = torch.eye(tri.shape[-1], dtype=torch.bool, device=dev)
            tri = torch.where(eye, torch.ones((), dtype=tri.dtype, device=dev), tri)
        if key.transa != "N":
            tri = tri.mH if key.transa == "C" else tri.transpose(-1, -2)
        x = outs[0][:lanes]
        lhs = tri @ x if key.side == "L" else x @ tri
        rhs = alpha[:, None, None] * b
        res = fro(lhs - rhs) / torch.clamp(fro(rhs), min=tiny)
    else:
        ah = herm(a)
        w, v = outs[0][:lanes], outs[1][:lanes]
        res = fro(ah @ v - v * w[:, None, :].to(v.dtype)) / torch.clamp(fro(ah), min=tiny)
    return res.cpu().numpy()


def _default_nb(n: int) -> int:
    from ..algorithms.batched import default_nb

    return default_nb(n)


def _split_outputs(op: str, out):
    """((lane outputs...), info vector) of one dispatch result (the
    queue's programs always carry info)."""
    if op == "eigh":
        w, v, info = out
        return (w, v), info
    return (out[0],), out[1]
