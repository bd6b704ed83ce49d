"""Shared miniapp options.

Counterpart of ``dlaf_tpu/miniapp/options.py`` (reference
``miniapp/include/dlaf/miniapp/options.h``): the process grid, runs,
warm-ups, the check-result mode, the element type, and the device.
``--backend`` is ``cuda`` (the default) or ``cpu``; asking for ``cuda``
where there is no GPU raises. A ``--grid-rows`` x ``--grid-cols`` grid
takes one visible device per rank and raises when there are fewer;
``--share-device`` puts every rank on the one device of ``--backend``
(the counterpart of the reference's virtual CPU devices).

Launched by ``torchrun`` (``WORLD_SIZE > 1`` in the environment), a
miniapp runs the multi-process form (:mod:`..comm.multihost`): one process
per rank of the ``--grid-rows`` x ``--grid-cols`` grid. Each process then
drives ``cuda:LOCAL_RANK`` over NCCL, or with ``--share-device`` the one
device of ``--backend`` over gloo (NCCL refuses two ranks on one card);
with ``--backend cpu`` the world runs on gloo. Only process 0 prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import os
import sys

import numpy as np
import torch

from ..comm import multihost
from ..comm.grid import Grid
from ..types import ELEMENT_TYPES


class CheckIterFreq(enum.Enum):
    NONE = "none"
    LAST = "last"
    ALL = "all"


@dataclasses.dataclass
class MiniappOptions:
    grid_rows: int = 1
    grid_cols: int = 1
    share_device: bool = False
    nruns: int = 1
    nwarmups: int = 1
    check: CheckIterFreq = CheckIterFreq.NONE
    dtype: type = np.float64
    backend: str = "cuda"


def add_miniapp_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--grid-rows", type=int, default=1, help="process grid rows")
    parser.add_argument("--grid-cols", type=int, default=1, help="process grid cols")
    parser.add_argument("--share-device", action="store_true",
                        help="put every rank of the grid on the one device of --backend")
    parser.add_argument("--nruns", type=int, default=1, help="timed runs")
    parser.add_argument("--nwarmups", type=int, default=1, help="warmup runs")
    parser.add_argument("--check-result", choices=[c.value for c in CheckIterFreq],
                        default="none", help="verify the result")
    parser.add_argument("--type", choices=list(ELEMENT_TYPES), default="d",
                        help="element type s/d/c/z")
    parser.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda)")


def parse_miniapp_options(args: argparse.Namespace) -> MiniappOptions:
    return MiniappOptions(grid_rows=args.grid_rows, grid_cols=args.grid_cols,
                          share_device=args.share_device, nruns=args.nruns,
                          nwarmups=args.nwarmups,
                          check=CheckIterFreq(args.check_result),
                          dtype=ELEMENT_TYPES[args.type], backend=args.backend)


def select_device(opts: MiniappOptions) -> torch.device:
    """The run's device; raises when ``cuda`` is asked for and absent."""
    if opts.backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda requested but no CUDA device is visible")
    return torch.device(opts.backend)


def select_devices(opts: MiniappOptions) -> list:
    """One device per rank of the grid, in rank order: the visible devices
    of ``--backend``, or its one device repeated with ``--share-device``.
    Raises when the grid needs more devices than are visible."""
    need = opts.grid_rows * opts.grid_cols
    if need < 1:
        raise SystemExit(f"invalid grid {opts.grid_rows}x{opts.grid_cols}")
    device = select_device(opts)
    if opts.share_device:
        return [device] * need
    visible = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    if len(visible) < need:
        raise SystemExit(
            f"grid {opts.grid_rows}x{opts.grid_cols} needs {need} devices but only "
            f"{len(visible)} {device.type} device(s) are visible; pass --share-device to put "
            "every rank on one device, or shrink the grid")
    return visible[:need]


def select_grid(opts: MiniappOptions, ordering: str = "row-major"):
    """The run's grid and this process's device: the single controller's
    grid over :func:`select_devices`, or, when ``torchrun`` launched this
    process as one of several (``WORLD_SIZE > 1``), the multi-process grid
    (module docstring), one rank per process."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        devices = select_devices(opts)
        return (Grid(opts.grid_rows, opts.grid_cols, devices=devices, ordering=ordering),
                devices[0])
    device = select_device(opts)
    if device.type == "cuda" and not opts.share_device:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    backend = "gloo" if opts.share_device or device.type == "cpu" else "nccl"
    multihost.initialize_multihost(backend=backend)
    grid = multihost.multihost_grid(opts.grid_rows, opts.grid_cols, device=device)
    return grid, device


def is_printer() -> bool:
    """Does this process print the run's lines (process 0 of the world, or
    the only process)?"""
    return multihost.process_info()[0] == 0


def root_verdict(grid, verdict) -> None:
    """Share a check's verdict, computed on the process that drives rank
    (0, 0) (the one that gathered the matrices; None elsewhere), with every
    process; each exits 1 when it failed."""
    src = grid.process_rank(0, 0) if grid is not None and grid.multi_process else 0
    if not multihost.broadcast_object(verdict, src=src):
        sys.exit(1)
