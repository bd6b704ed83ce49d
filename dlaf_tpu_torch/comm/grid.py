"""2-D process grid over torch devices.

Counterpart of ``dlaf_tpu/comm/grid.py`` (reference ``Communicator`` /
``CommunicatorGrid``). The JAX package is single-controller SPMD: its grid
is a device mesh, and a ``shard_map`` body runs once per mesh coordinate.
The port keeps the single controller: one Python process drives every rank
of the grid in turn, each rank's tile shard lives on that rank's device,
and the verbs of :mod:`.collectives` move tensors between the ranks'
devices. A grid may place several ranks on one device (``devices`` may
repeat an entry): the counterpart of the virtual CPU devices the JAX tests
run on, and how one card runs a whole grid.

``ROW_AXIS`` indexes grid rows (ranks in one grid column differ along it),
``COL_AXIS`` grid columns; every collective verb takes one of them.
"""

from __future__ import annotations

import torch

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
        """Device of rank ``(r, c)``."""
        return self._dev[r][c]

    @property
    def devices(self) -> list:
        """Devices by rank, row-major rank order (rank ``(r, c)`` at
        ``r * cols + c``)."""
        return [d for row in self._dev for d in row]

    @property
    def distinct_devices(self) -> list:
        return list(dict.fromkeys(self.devices))

    def __str__(self) -> str:
        shared = len(self.distinct_devices) < self.num_devices
        return (f"Grid({self._size.row}x{self._size.col}, {self._ordering}"
                f"{', shared devices' if shared else ''})")


def shared_grid(rows: int, cols: int, device) -> Grid:
    """A rows x cols grid with every rank on ``device``."""
    return Grid(rows, cols, devices=[device] * (rows * cols))
