"""Shared miniapp options.

Counterpart of ``dlaf_tpu/miniapp/options.py`` (reference
``miniapp/include/dlaf/miniapp/options.h``): runs, warm-ups, the
check-result mode, the element type, and the device. ``--backend`` is
``cuda`` (the default) or ``cpu``; asking for ``cuda`` where there is no
GPU raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum

import numpy as np
import torch

from ..types import ELEMENT_TYPES


class CheckIterFreq(enum.Enum):
    NONE = "none"
    LAST = "last"
    ALL = "all"


@dataclasses.dataclass
class MiniappOptions:
    nruns: int = 1
    nwarmups: int = 1
    check: CheckIterFreq = CheckIterFreq.NONE
    dtype: type = np.float64
    backend: str = "cuda"


def add_miniapp_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--nruns", type=int, default=1, help="timed runs")
    parser.add_argument("--nwarmups", type=int, default=1, help="warmup runs")
    parser.add_argument("--check-result", choices=[c.value for c in CheckIterFreq],
                        default="none", help="verify the result")
    parser.add_argument("--type", choices=list(ELEMENT_TYPES), default="d",
                        help="element type s/d/c/z")
    parser.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda)")


def parse_miniapp_options(args: argparse.Namespace) -> MiniappOptions:
    return MiniappOptions(nruns=args.nruns, nwarmups=args.nwarmups,
                          check=CheckIterFreq(args.check_result),
                          dtype=ELEMENT_TYPES[args.type], backend=args.backend)


def select_device(opts: MiniappOptions) -> torch.device:
    """The run's device; raises when ``cuda`` is asked for and absent."""
    if opts.backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--backend cuda requested but no CUDA device is visible")
    return torch.device(opts.backend)
