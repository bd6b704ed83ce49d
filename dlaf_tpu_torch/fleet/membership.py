"""Fleet membership: the router's per-worker liveness table.

Port of ``dlaf_tpu/fleet/membership.py``. Reader threads only RECORD here
(:meth:`Membership.beat` on every message received); every liveness
DECISION (the heartbeat-timeout evaluation and the transitions the router
acts on) is taken at a router clock edge (``Router.poll``), against the
injected ``clock``, so drills replay exactly, as ``serve.Queue``'s
deadlines do.

States of one worker::

    up ──(heartbeat_timeout_s without traffic)──> suspect
    suspect ──(any message arrives)──> up
    up|suspect ──(drain announced)──> draining
    any ──(socket EOF / drain completed)──> dead

``suspect`` stays ROUTABLE: the worker's circuit breaker (forced open at
the timeout) is what gates its traffic, so readmission follows the
half-open probe of :mod:`dlaf_tpu_torch.health.circuit`: one real request
probes the recovered worker, a success closes the breaker, a failure opens
it again. ``dead`` and ``draining`` are never routable.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

#: States a worker can be routed in (``suspect`` included: its breaker
#: gates it).
ROUTABLE_STATES = ("up", "suspect")


@dataclasses.dataclass
class Member:
    worker: int
    pid: Optional[int]
    state: str              # "up" | "suspect" | "draining" | "dead"
    last_seen: float
    reason: str = ""        # why dead or suspect ("eof", "heartbeat_timeout",
                            # "drained", ...)


class Membership:
    """The router's worker table (module docstring). ``clock`` is the
    router's injected clock; ``heartbeat_timeout_s`` the silence after
    which an ``up`` worker turns ``suspect``."""

    def __init__(self, *, heartbeat_timeout_s: float, clock: Callable[[], float]):
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.clock = clock
        self._members: dict = {}        # worker -> Member
        self._lock = threading.Lock()

    # -- recording (reader threads and the router) -------------------------

    def add(self, worker: int, pid: Optional[int] = None) -> None:
        with self._lock:
            self._members[int(worker)] = Member(worker=int(worker), pid=pid, state="up",
                                                last_seen=self.clock())

    def beat(self, worker: int) -> None:
        """Any message from ``worker`` is proof of life: refresh
        ``last_seen`` and lift ``suspect`` back to ``up`` (dead and
        draining are final: a late pong does not revive a worker)."""
        with self._lock:
            m = self._members.get(int(worker))
            if m is None:
                return
            m.last_seen = self.clock()
            if m.state == "suspect":
                m.state = "up"
                m.reason = ""

    def mark_draining(self, worker: int) -> None:
        with self._lock:
            m = self._members.get(int(worker))
            if m is not None and m.state != "dead":
                m.state = "draining"

    def mark_dead(self, worker: int, reason: str) -> None:
        with self._lock:
            m = self._members.get(int(worker))
            if m is not None and m.state != "dead":
                m.state = "dead"
                m.reason = str(reason)

    # -- decisions (router clock edges only) -------------------------------

    def timed_out(self, now: float) -> list:
        """Flip every ``up`` worker silent longer than
        ``heartbeat_timeout_s`` to ``suspect`` and return their indices,
        sorted (the router force-opens their breakers and re-dispatches
        their unacknowledged tickets)."""
        flipped = []
        with self._lock:
            for m in self._members.values():
                if m.state == "up" and now - m.last_seen > self.heartbeat_timeout_s:
                    m.state = "suspect"
                    m.reason = "heartbeat_timeout"
                    flipped.append(m.worker)
        return sorted(flipped)

    # -- introspection -----------------------------------------------------

    def state(self, worker: int) -> Optional[str]:
        with self._lock:
            m = self._members.get(int(worker))
            return m.state if m is not None else None

    def routable(self) -> list:
        """The workers traffic may go to, sorted (the stable order the
        router's bucket assignment indexes)."""
        with self._lock:
            return sorted(w for w, m in self._members.items() if m.state in ROUTABLE_STATES)

    def states(self) -> dict:
        """``{worker: {state, pid, last_seen, reason}}``: the fleet section
        of the aggregated health view."""
        with self._lock:
            return {m.worker: {"state": m.state, "pid": m.pid, "last_seen": m.last_seen,
                               "reason": m.reason}
                    for m in sorted(self._members.values(), key=lambda m: m.worker)}
