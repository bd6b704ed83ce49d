"""dlaf_tpu_torch.fleet: the multi-replica serve tier with failover.

Port of ``dlaf_tpu/fleet/``. A :class:`~.router.Router` front tier shards
bucketed requests across N :class:`~.worker.FleetWorker` replicas, each
the single-process serve stack (``serve.Queue`` over a
``ProgramService`` on its device), over the length-prefixed JSON
transport of :mod:`.transport`.

The contract:

* every accepted request gets a durable router-owned
  :class:`~.router.FleetTicket`; a worker's death re-dispatches its
  unacknowledged tickets to siblings (at-least-once, never dropped);
* liveness is heartbeat-based, with timeouts read against an injectable
  clock (:mod:`.membership`), so drills replay exactly;
* routing is breaker-aware per worker (``fleet.worker{k}`` sites,
  readmission by a half-open probe);
* SIGTERM drains gracefully (``Queue.drain()`` handback, zero
  re-dispatches), SIGKILL drives the failover;
* every decision is a ``fleet`` JSONL record (``python -m
  dlaf_tpu_torch.obs.validate --require-fleet``), and a worker's death
  trips the flight recorder (``fleet_worker_down``).
"""

from __future__ import annotations

from .membership import Membership  # noqa: F401
from .router import DISPATCH_SITE, FleetTicket, RemoteError, Router, worker_site  # noqa: F401
from .transport import (MAX_FRAME_BYTES, TransportClosed, TransportIdle,  # noqa: F401
                        recv_msg, send_msg)


def __getattr__(name: str):
    # .worker is loaded lazily, so that ``python -m
    # dlaf_tpu_torch.fleet.worker`` does not import it twice (runpy warns
    # when the -m target is already in sys.modules)
    if name in ("FleetWorker", "connect_worker"):
        from . import worker
        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DISPATCH_SITE", "FleetTicket", "FleetWorker", "MAX_FRAME_BYTES",
    "Membership", "RemoteError", "Router", "TransportClosed",
    "TransportIdle", "connect_worker", "recv_msg", "send_msg",
    "worker_site",
]
