"""The multi-process form: one process per rank of the grid.

Counterpart of ``dlaf_tpu/comm/multihost.py``. The reference scales past
one process with MPI (``communication/init.h``); the JAX package with
``jax.distributed`` and SPMD, each process driving its own devices'
shards of the same ``shard_map`` programs. Here:

* process world      -> ``torch.distributed.init_process_group``
  (:func:`initialize_multihost`; with no arguments it reads the
  ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` that ``torchrun``
  sets, the counterpart of Cloud TPU's automatic discovery);
* rank               -> ``torch.distributed.get_rank()``
  (:func:`process_info`);
* grid over the world -> :func:`multihost_grid`: a 2-D grid with one
  process per rank, each process holding only its rank's shard on its
  own device, with one process group per grid row and one per grid
  column, on which the verbs of :mod:`.collectives` run.

Backends: ``"nccl"`` moves CUDA tensors between processes with one card
each; ``"gloo"`` runs on the CPU, and is what processes that share one
card must ask for (NCCL refuses two ranks on one device): a gloo group
stages CUDA tensors through host memory (``collectives._transport``).
:func:`multihost_grid` raises when an NCCL world puts two ranks on one
device; there is no silent switch from one backend to the other.

Axis policy (:func:`layout_2d`, the reference's ``:184-215``): one node's
NVLink island plays the part of the TPU slice's ICI island. Where the
per-node process count is a multiple of ``cols`` the column axis (the
panel broadcasts' hot axis) stays inside a node; otherwise the layout is
node-major. The reference routes the first case through
``mesh_utils.create_hybrid_device_mesh``, which has no counterpart here;
its heuristic branch gives the same placement.

Data loading: each process builds only its own shard
(:meth:`..matrix.matrix.Matrix.from_element_fn` evaluates the element
function on the local tiles), so no process materializes the global
matrix: the reference's per-rank tile allocation.

Once the world is up, :func:`initialize_multihost` pins the process rank
onto :mod:`..obs` (``obs.set_rank``) and re-resolves a ``%r`` metrics
path, so each process writes its own artifact; the connect's retries are
counted there (``dlaf_retry_total{site="multihost.connect"}``, through
:mod:`..health.policy`), as the reference's (``multihost.py:117-126``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.asserts import dlaf_assert
from . import collectives as cc
from .grid import Grid, normalize_device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         timeout: Optional[float] = 300.0,
                         connect_attempts: int = 3,
                         connect_backoff_s: float = 1.0) -> None:
    """Establish the process world (the ``mpi_init`` analog).

    With no arguments the world comes from the environment ``torchrun``
    sets (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); elsewhere pass the coordinator (``host:port``, or
    an init-method URL such as ``tcp://host:port`` or ``file:///path``),
    the world size and this process's rank. A no-op when the world has a
    single process. ``backend`` defaults to ``"nccl"`` where CUDA is
    available and ``"gloo"`` otherwise; processes that share one card
    must pass ``"gloo"``.

    ``timeout`` bounds each connect attempt and the world's collectives
    (seconds). The connect runs on :mod:`..health.policy`: a transient
    bring-up failure (timeout, connection refused, unreachable:
    :func:`_is_bringup_failure`) retries up to ``connect_attempts`` times
    with exponential backoff from ``connect_backoff_s``, since a
    coordinator that is still starting is the common bring-up race.
    Caller bugs (a second initialization, bad arguments) raise at once
    with their own message. Exhaustion raises a ``RuntimeError`` naming
    the coordinator, the world and the usual causes."""
    if coordinator_address is None:
        if num_processes is None:
            num_processes = int(os.environ.get("WORLD_SIZE", "1"))
        if num_processes == 1:
            return   # one process: nothing to establish
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dlaf_assert(backend in ("nccl", "gloo"), f"unknown backend {backend!r}")
    from ..health.policy import RetryPolicy, with_policy

    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))

    def _connect():
        dist.init_process_group(backend=backend, init_method=init_method, **kwargs)

    policy = RetryPolicy(max_attempts=max(int(connect_attempts), 1),
                         backoff_base_s=float(connect_backoff_s),
                         retryable=_is_bringup_failure)
    try:
        with_policy("multihost.connect", _connect, policy=policy)
    except Exception as e:
        if not _is_bringup_failure(e):
            raise   # caller bugs (double init, bad args) keep their message
        world = f"{num_processes} process(es)" if num_processes else "auto"
        raise RuntimeError(
            f"multi-process bring-up failed: could not establish the process "
            f"world (coordinator={coordinator_address!r}, world={world}, "
            f"process_id={process_id!r}, backend={backend!r}"
            + (f", timeout={int(timeout)}s" if timeout is not None else "")
            + f"): {e}. Check that (1) the coordinator host:port is "
            "reachable from this host (firewall/VPC rules), (2) EVERY "
            "process of the world starts within the timeout with the SAME "
            "coordinator address and world size, and (3) process ids are "
            "unique in [0, world). Under torchrun, omit all arguments: the "
            "world comes from the environment it sets.") from e
    # pin the rank onto the observability layer and re-resolve the metrics
    # path: a %r template expanded before the world came up would have
    # sent every process to one file
    from .. import obs
    from ..config import get_configuration

    rank = dist.get_rank() if dist.is_initialized() else process_id
    if rank is not None:
        obs.set_rank(rank)
    cfg = get_configuration()
    if "%r" in (cfg.metrics_path or ""):
        obs.configure(log_level=cfg.log, metrics_path=cfg.metrics_path,
                      trace_dir=cfg.trace_dir, metrics_port=cfg.metrics_port,
                      flight_recorder=cfg.flight_recorder)


def _is_bringup_failure(e: BaseException) -> bool:
    """Does this look like a coordinator-connect failure (worth the
    actionable bring-up diagnosis) rather than a caller bug? A second
    initialization or bad arguments keep their own message: sending an
    operator to debug firewalls for those would be worse than no wrapping
    at all."""
    if isinstance(e, (TimeoutError, ConnectionError, OSError)):
        return True
    text = str(e).lower()
    return any(s in text for s in ("timeout", "timed out", "deadline", "unavailable",
                                   "connect", "refused", "unreachable"))


def finalize_multihost() -> None:
    """Leave the process world (``MPI_Finalize``): uninstall the grid and
    destroy the process groups. A no-op without a world."""
    cc.install_world(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple:
    """``(rank, world size)`` of this process; ``(0, 1)`` without a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class ProcessEntry:
    """One process of the world: its global rank and its node's name."""
    rank: int
    node: str


def slice_groups(entries: Sequence) -> dict:
    """Group processes by node (``entry.node``; one group where entries
    have none): one node's NVLink island, the counterpart of a TPU
    slice's ICI island."""
    groups: dict = {}
    for e in entries:
        groups.setdefault(getattr(e, "node", 0), []).append(e)
    return groups


def layout_2d(entries: Sequence, rows: int, cols: int) -> np.ndarray:
    """The topology-aware ``(rows, cols)`` layout of the world's processes,
    a pure function of the entries and their node grouping (module
    docstring): the column axis inside one node where the per-node count
    is a multiple of ``cols``, node-major where either count divides the
    other, entry order otherwise."""
    n = len(entries)
    dlaf_assert(rows * cols == n, f"multi-process grid {rows}x{cols} must use all {n} processes")
    groups = slice_groups(entries)
    ordered = list(entries)
    if len(groups) > 1:
        sizes = {len(g) for g in groups.values()}
        dlaf_assert(len(sizes) == 1, "nodes with different process counts are unsupported")
        per = sizes.pop()
        if cols % per == 0 or per % cols == 0:
            ordered = [e for k in sorted(groups) for e in groups[k]]
    return np.array(ordered, dtype=object).reshape(rows, cols)


def refuse_shared_nccl(seen: Sequence) -> None:
    """Raise unless every process of an NCCL world has a CUDA device of its
    own: ``seen`` holds each process's ``(node, device)``. NCCL refuses two
    ranks on one device, so such a world must say ``backend="gloo"``."""
    for node, device in seen:
        if not device.startswith("cuda"):
            raise ValueError(f"an NCCL world needs a CUDA device per process, got {device} on "
                             f"{node}; pass backend=\"gloo\" to initialize_multihost for the CPU")
    if len(set(seen)) < len(seen):
        raise ValueError(
            "NCCL refuses two ranks on one device, and this world puts several processes on "
            f"one device ({sorted(seen)}); processes that share a card must pass "
            "backend=\"gloo\" to initialize_multihost (the miniapps: --share-device)")


def _squarest(n: int) -> tuple[int, int]:
    rows = int(np.sqrt(n))
    while n % rows:
        rows -= 1
    return rows, n // rows


def multihost_grid(rows: Optional[int] = None, cols: Optional[int] = None, *,
                   device=None) -> Grid:
    """The multi-process grid over every process of the world, this
    process driving one rank; installed as the world the verbs of
    :mod:`.collectives` run on. Collective: every process calls it with
    the same arguments.

    ``rows``/``cols`` omitted: the squarest factorization of the world
    size. ``device`` defaults to ``cuda:LOCAL_RANK`` (``cpu`` without
    CUDA); pass it for processes that share one card (``cuda:0``, with a
    gloo world) or run on the CPU. An NCCL world whose processes put two
    ranks on one device raises: NCCL refuses that; such a grid needs
    ``initialize_multihost(backend="gloo")``."""
    dlaf_assert(dist.is_available() and dist.is_initialized(),
                "multihost_grid: no process world; call initialize_multihost first")
    rank, n = process_info()
    if rows is None or cols is None:
        rows, cols = _squarest(n)
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = normalize_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # the device NCCL's object collectives use
    backend = dist.get_backend()
    node = socket.gethostname()
    seen = [None] * n
    dist.all_gather_object(seen, (node, str(device)))
    if backend == "nccl":
        refuse_shared_nccl(seen)
    entries = [ProcessEntry(i, seen[i][0]) for i in range(n)]
    lay = layout_2d(entries, rows, cols)
    process_of = [[int(lay[r, c].rank) for c in range(cols)] for r in range(rows)]
    where = {process_of[r][c]: (r, c) for r in range(rows) for c in range(cols)}
    # new_group is collective: every process creates every group, in one order
    row_groups = [dist.new_group(sorted(process_of[r])) for r in range(rows)]
    col_groups = [dist.new_group(sorted(process_of[r][c] for r in range(rows)))
                  for c in range(cols)]
    grid = Grid.one_rank_per_process(rows, cols, local_rank=where[rank], device=device,
                                     process_of=process_of, row_groups=row_groups,
                                     col_groups=col_groups, backend=backend)
    cc.install_world(grid)
    return grid


def broadcast_object(obj, src: int = 0):
    """``obj`` of process ``src`` on every process (itself without a world),
    pickled: how a verdict or another small value that one process
    computed reaches the others (arrays cross by the transport:
    ``cc.bcast_arrays``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
