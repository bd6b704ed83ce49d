"""2-D process grid over torch devices.

Counterpart of ``dlaf_tpu/comm/grid.py`` (reference ``Communicator`` /
``CommunicatorGrid``). The JAX package is single-controller SPMD: its grid
is a device mesh, and a ``shard_map`` body runs once per mesh coordinate.
A grid has one of two forms:

* the single controller: one Python process drives every rank of the grid
  in turn, each rank's tile shard lives on that rank's device, and the
  verbs of :mod:`.collectives` move tensors between the ranks' devices. A
  grid may place several ranks on one device (``devices`` may repeat an
  entry): the counterpart of the virtual CPU devices the JAX tests run on,
  and how one card runs a whole grid;
* the multi-process form (:func:`.multihost.multihost_grid`): one process
  per rank, each holding only its own rank's shard on its own device, and
  the verbs run on ``torch.distributed`` process groups, one per grid row
  and one per grid column. Only that grid's constructor builds this form.

``local_ranks`` lists the ranks this process drives: every rank in the
first form, one in the second. A single-controller grid made in a process
whose ``torch.distributed`` world has more than one process raises, so
the two forms never mix.

``ROW_AXIS`` indexes grid rows (ranks in one grid column differ along it),
``COL_AXIS`` grid columns; every collective verb takes one of them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..common.asserts import dlaf_assert
from ..common.index2d import GridSize2D

ROW_AXIS = "row"
COL_AXIS = "col"


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` -> the
    current CUDA device), so that two names of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Grid:
    """A rows x cols grid of ranks, each on a torch device.

    ``devices`` (default: every visible CUDA device) fills the grid in
    ``ordering``: "row-major" puts device ``i`` at ``(i // cols, i %
    cols)``, "col-major" at ``(i % rows, i // rows)``, as the reference's
    ``common::Ordering``. The grid needs ``rows * cols`` entries; an entry
    may repeat, and then several ranks share that device.
    """

    def __init__(self, rows: int, cols: int, devices=None, ordering: str = "row-major"):
        dlaf_assert(rows > 0 and cols > 0, f"invalid grid {rows}x{cols}")
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise RuntimeError(
                f"a single-controller grid in a world of {dist.get_world_size()} processes: "
                "each process drives one rank there; build the grid with "
                "dlaf_tpu_torch.comm.multihost.multihost_grid")
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [normalize_device(d) for d in devices]
        need = rows * cols
        dlaf_assert(need <= len(devices),
                    f"grid {rows}x{cols} needs {need} devices, have {len(devices)}")
        devices = devices[:need]
        if ordering == "row-major":
            self._dev = [[devices[r * cols + c] for c in range(cols)] for r in range(rows)]
        elif ordering == "col-major":
            self._dev = [[devices[c * rows + r] for c in range(cols)] for r in range(rows)]
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
        self._size = GridSize2D(rows, cols)
        self._ordering = ordering
        self._local = [(r, c) for r in range(rows) for c in range(cols)]
        self._procs = None
        self.backend = None

    @classmethod
    def one_rank_per_process(cls, rows: int, cols: int, *, local_rank: tuple, device,
                             process_of, row_groups: list, col_groups: list,
                             backend: str) -> "Grid":
        """The multi-process form (only :func:`.multihost.multihost_grid`
        calls this): this process drives rank ``local_rank`` on ``device``;
        ``process_of[r][c]`` is the global process rank of grid position
        ``(r, c)``, ``row_groups[r]`` the process group of grid row ``r``
        and ``col_groups[c]`` that of grid column ``c``, all on
        ``backend``."""
        g = cls.__new__(cls)
        g._size = GridSize2D(rows, cols)
        g._ordering = "row-major"
        g._local = [tuple(local_rank)]
        g._dev = [[normalize_device(device) if (r, c) == tuple(local_rank) else None
                   for c in range(cols)] for r in range(rows)]
        g._procs = [list(row) for row in process_of]
        g._row_groups, g._col_groups = list(row_groups), list(col_groups)
        g.backend = backend
        return g

    @property
    def multi_process(self) -> bool:
        """Is this the multi-process form (one process per rank)?"""
        return self._procs is not None

    @property
    def local_ranks(self) -> list:
        """The ranks ``(r, c)`` this process drives, row-major: every rank
        of a single-controller grid, one of a multi-process grid."""
        return list(self._local)

    def is_local(self, r: int, c: int) -> bool:
        return (r, c) in self._local

    def process_rank(self, r: int, c: int) -> int:
        """Global process rank of grid position ``(r, c)`` (multi-process
        form)."""
        return self._procs[r][c]

    def row_group(self, r: int):
        """Process group of the ranks of grid row ``r`` (multi-process
        form): the group of the column-axis verbs."""
        return self._row_groups[r]

    def col_group(self, c: int):
        """Process group of the ranks of grid column ``c`` (multi-process
        form): the group of the row-axis verbs."""
        return self._col_groups[c]

    @property
    def size(self) -> GridSize2D:
        return self._size

    @property
    def num_devices(self) -> int:
        """Ranks of the grid (the reference's mesh size); ranks that share
        a device count once each."""
        return self._size.row * self._size.col

    @property
    def ordering(self) -> str:
        return self._ordering

    def device(self, r: int, c: int) -> torch.device:
        """Device of rank ``(r, c)``; None for a rank another process
        drives."""
        return self._dev[r][c]

    @property
    def devices(self) -> list:
        """Devices by rank, row-major rank order (rank ``(r, c)`` at
        ``r * cols + c``); None for a rank another process drives."""
        return [d for row in self._dev for d in row]

    @property
    def distinct_devices(self) -> list:
        return list(dict.fromkeys(d for d in self.devices if d is not None))

    def __str__(self) -> str:
        if self.multi_process:
            r, c = self._local[0]
            return (f"Grid({self._size.row}x{self._size.col}, one process per rank, "
                    f"rank ({r}, {c}) on {self._dev[r][c]}, {self.backend})")
        shared = len(self.distinct_devices) < self.num_devices
        return (f"Grid({self._size.row}x{self._size.col}, {self._ordering}"
                f"{', shared devices' if shared else ''})")


def shared_grid(rows: int, cols: int, device) -> Grid:
    """A rows x cols grid with every rank on ``device``."""
    return Grid(rows, cols, devices=[device] * (rows * cols))
