"""Fleet worker: one serve replica behind the router.

Port of ``dlaf_tpu/fleet/worker.py``. A :class:`FleetWorker` wraps the
replica's serve stack, one :class:`..serve.queue.Queue` over one
:class:`..serve.programs.ProgramService` on the worker's device, and
speaks the :mod:`.transport` protocol back to the router over one
connect-back socket. The port keeps no persistent compile cache: a worker
is warm for a bucket once the router's ``warmup`` message has readied that
bucket's program in it.

The protocol loop is SINGLE-THREADED on purpose: a wedged dispatch blocks
the pong too, so the router's heartbeat timeout sees real unresponsiveness,
not just a live socket. A dispatch waits for the device (the queue's
results come back to the host), so a worker's silence lasts as long as its
longest dispatch. Deadline dispatch of partial batches still works: every
incoming message and every idle tick is a queue clock edge
(``queue.poll()``), as in the serve layer.

Messages, router to worker: ``submit`` (one wire request, the router's
ticket seq and trace ID), ``flush``, ``ping``, ``healthz``, ``warmup``
(wire ProgramSpecs), ``drain``. Worker to router: ``hello``, ``result``
(the acknowledgement: a ticket is the router's until it arrives),
``pong``, ``healthz``, ``warmed``, ``draining``, ``drained`` (with the
handed-back seqs).

Shutdown: SIGTERM (or a router ``drain``) takes the GRACEFUL path: stop
admission, take the submits already in the socket buffer as unstarted
handbacks, let the in-flight dispatch finish (it has, the loop being
single-threaded), ``Queue.drain()`` the undispatched rest, send the results
and the ``drained`` handback, exit 0. SIGKILL skips all of that and drives
the router's failover instead.

``python -m dlaf_tpu_torch.fleet.worker --connect HOST:PORT --worker K
[--backend cuda|cpu]``: the worker process; ``cuda`` (the default) puts its
queue's programs on the card and fails, with a non-zero exit, where no
card is visible.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
from typing import Optional

import torch

from .. import obs
from ..health.errors import DrainedError
from ..serve.programs import ProgramService, ProgramSpec
from ..serve.queue import Queue, Request, array_to_wire
from . import transport

#: Socket timeout of the protocol loop: the idle tick at which the worker
#: polls its queue's deadlines and checks the drain flag.
IDLE_TICK_S = 0.05


class FleetWorker:
    """One worker's protocol loop over a connected socket (module
    docstring). ``queue`` defaults to a fresh config-driven
    :class:`..serve.queue.Queue` on the default service; tests pass one
    with a fake clock or a small batch."""

    def __init__(self, sock: socket.socket, worker: int, queue: Optional[Queue] = None,
                 idle_tick_s: float = IDLE_TICK_S):
        self.sock = sock
        self.worker = int(worker)
        self.queue = queue if queue is not None else Queue()
        self.idle_tick_s = float(idle_tick_s)
        self._tickets: dict = {}        # router seq -> serve Ticket
        self._draining = False
        self._killed = False

    # -- control (the signal handler, tests) -------------------------------

    def request_drain(self) -> None:
        """Arm the graceful drain, taken at the next loop tick (the SIGTERM
        handler calls this; nothing here is unsafe in a handler)."""
        self._draining = True

    def kill(self) -> None:
        """The SIGKILL stand-in of in-process drill workers: drop the
        connection with no drain and no handback, unacknowledged tickets
        and all: the router must see the EOF and fail over."""
        self._killed = True
        try:
            self.sock.close()
        except OSError:
            pass

    # -- the loop ----------------------------------------------------------

    def serve(self) -> None:
        """Run the protocol loop until a drain completes or the router goes
        away. Sends ``hello`` first: the router learns the worker's index
        and pid from it, never from the order of connections."""
        self.sock.settimeout(self.idle_tick_s)
        self._send({"kind": "hello", "worker": self.worker, "pid": os.getpid()})
        try:
            while True:
                if self._draining:
                    self._drain()
                    return
                try:
                    msg = transport.recv_msg(self.sock, idle_ok=True)
                except transport.TransportIdle:
                    # an idle tick is a queue clock edge: partial batches
                    # past their deadline dispatch here, results ack here
                    self._poll_safely()
                    self._pump()
                    continue
                self._handle(msg)
                self._pump()
        except (transport.TransportClosed, OSError):
            # the router went away (or kill()): nobody is left to report to
            return
        finally:
            if not self._killed:
                try:
                    self.sock.close()
                except OSError:
                    pass

    # -- messages ----------------------------------------------------------

    def _handle(self, msg: dict) -> None:
        kind = msg.get("kind")
        if kind == "submit":
            self._submit(msg)
        elif kind == "flush":
            try:
                self.queue.flush()
            except Exception:
                pass            # the failed tickets carry the cause; _pump acks
        elif kind == "ping":
            self._poll_safely()
            self._send({"kind": "pong", "worker": self.worker})
        elif kind == "healthz":
            self._send({"kind": "healthz", "worker": self.worker,
                        "payload": obs.exporter.healthz_payload()})
        elif kind == "warmup":
            specs = [ProgramSpec.from_wire(d) for d in msg.get("specs", [])]
            walls = self.queue.service.warmup(*specs)
            self._send({"kind": "warmed", "worker": self.worker,
                        "compile_s": float(sum(walls.values()))})
        elif kind == "drain":
            self._draining = True

    def _submit(self, msg: dict) -> None:
        seq = int(msg["seq"])
        req = Request.from_wire(msg["req"])
        # sweep OTHER buckets' deadlines first, so that a failure there
        # (whose tickets are all mapped) is never taken for this submit's
        self._poll_safely()
        try:
            self._tickets[seq] = self.queue.submit(req, trace_id=msg.get("trace_id"))
        except Exception as e:
            # shed (OverloadError), or this bucket's inline dispatch failed
            # after the queue's own retries: acknowledge the cause; a
            # processed and failed request is final for the router
            self._send_error(seq, e)

    def _poll_safely(self) -> None:
        try:
            self.queue.poll()
        except Exception:
            pass                # failed tickets are acknowledged by _pump

    # -- results -----------------------------------------------------------

    def _pump(self) -> None:
        """Acknowledge every resolved ticket (result or error) to the
        router; drained tickets are not acknowledged as errors: the drain's
        handback owns them."""
        for seq in [s for s, t in self._tickets.items() if t.done or t.error is not None]:
            ticket = self._tickets[seq]
            if ticket.done:
                out = ticket._result
                arrays = list(out) if isinstance(out, tuple) else [out]
                self._send({"kind": "result", "seq": seq, "ok": True, "worker": self.worker,
                            "arrays": [array_to_wire(a) for a in arrays],
                            "info": ticket.info, "queue_s": ticket.queue_s,
                            "total_s": ticket.total_s})
            elif isinstance(ticket.error, DrainedError):
                continue
            else:
                self._send_error(seq, ticket.error)
            del self._tickets[seq]

    def _send_error(self, seq: int, exc: BaseException) -> None:
        self._send({"kind": "result", "seq": seq, "ok": False, "worker": self.worker,
                    "error": {"type": type(exc).__name__, "message": str(exc)}})

    def _send(self, msg: dict) -> None:
        # a frame goes out whole however long the router takes to read it:
        # the idle tick bounds receiving only. Under it a result frame of a
        # real bucket (hundreds of KB) times out within ``sendall`` when the
        # router's reader thread is slow to drain the socket, and a timed-out
        # ``sendall`` leaves a torn frame, so the worker would drop out
        self.sock.settimeout(None)
        try:
            transport.send_msg(self.sock, msg)
        finally:
            self.sock.settimeout(self.idle_tick_s)

    # -- graceful drain ----------------------------------------------------

    def _drain(self) -> None:
        """The SIGTERM / router ``drain`` path (module docstring)."""
        self._send({"kind": "draining", "worker": self.worker})
        # the submits already in the socket buffer: admission is stopped,
        # so they are unstarted, and go back
        handback = []
        idle = 0
        while idle < 2:
            try:
                msg = transport.recv_msg(self.sock, idle_ok=True)
            except (transport.TransportIdle, transport.TransportClosed, OSError):
                idle += 1
                continue
            if msg.get("kind") == "submit":
                handback.append(int(msg["seq"]))
            elif msg.get("kind") == "ping":
                self._send({"kind": "pong", "worker": self.worker})
        # the in-flight dispatch (if any) completed already: acknowledge
        # its results, then hand back the undispatched rest
        self._pump()
        drained = {id(t) for _, t in self.queue.drain()}
        for seq in [s for s, t in self._tickets.items() if id(t) in drained]:
            handback.append(seq)
            del self._tickets[seq]
        self._pump()            # drain() may have raced a done ticket
        self._send({"kind": "drained", "worker": self.worker, "handback": sorted(handback)})
        try:
            self.sock.close()
        except OSError:
            pass


def connect_worker(port: int, worker: int, host: str = "127.0.0.1",
                   queue: Optional[Queue] = None,
                   idle_tick_s: float = IDLE_TICK_S) -> FleetWorker:
    """Dial the router and wrap the connection (the worker process below
    and the tests' in-process workers)."""
    sock = socket.create_connection((host, int(port)))
    return FleetWorker(sock, worker, queue=queue, idle_tick_s=idle_tick_s)


def main(argv=None) -> int:
    """The worker process (module docstring). ``obs.set_rank(K)`` runs
    before any sink write, so a ``%r`` metrics path puts each worker's
    records in its own shard; SIGTERM arms the graceful drain."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--connect", required=True, help="router address, HOST:PORT")
    parser.add_argument("--worker", required=True, type=int,
                        help="this worker's fleet index (also its obs rank for %%r "
                        "path templates)")
    parser.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                        help="device of the worker's bucket programs (cuda: the card, "
                        "which must be visible)")
    args = parser.parse_args(argv)
    host, port = args.connect.rsplit(":", 1)
    obs.set_rank(args.worker)
    if args.backend == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("fleet worker: --backend cuda requested but no CUDA device "
                             "is visible")
        # the CUDA context comes up before the hello, so the router's
        # heartbeat never waits on it
        torch.zeros(1, device="cuda").cpu()
    w = connect_worker(int(port), args.worker, host=host,
                       queue=Queue(ProgramService(device=args.backend)))
    signal.signal(signal.SIGTERM, lambda *_: w.request_drain())
    try:
        w.serve()
    finally:
        obs.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
