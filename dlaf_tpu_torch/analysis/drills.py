"""Seeded-bad programs that MUST trip the analysis gate.

Port of ``dlaf_tpu/analysis/drills.py``: a checker whose failure mode has
never been demonstrated is not a gate. Each drill builds a torch program
(or a source snippet) carrying exactly one violation; ``python -m
dlaf_tpu_torch.analysis --drill <name>`` must exit 1 with the expected
rule named in its output. The graph drills record real calls through
:func:`.depgraph.trace`, the auditor's own path, so a drill that stops
tripping means the CHECK broke, not the drill.

The reference's ``dropped_carry`` is ``dropped_output`` here (an eager
loop has no carry: it trips ``graph-dead-output`` only), and its
``_x64``/``_mesh22`` helpers have no counterpart (torch keeps float64 as
it is; the rank-varying drill runs the four rank identities of a 2x2
world in one process through a dry transport).
"""

from __future__ import annotations

import contextlib
import types
from typing import Callable, Dict, List, Tuple

from . import depgraph, graphcheck, lint
from .findings import Finding


class _DryWorld:
    """The multi-process world as one rank of a ``P x Q`` grid sees it,
    with no process group behind it."""

    multi_process = True

    def __init__(self, P: int, Q: int, r: int, c: int):
        self.size = types.SimpleNamespace(row=P, col=Q)
        self.local_ranks = [(r, c)]

    def process_rank(self, r: int, c: int) -> int:
        return r * self.size.col + c

    def row_group(self, r: int):
        return ("row", r)

    def col_group(self, c: int):
        return ("col", c)

    def is_local(self, r: int, c: int) -> bool:
        return (r, c) == self.local_ranks[0]


@contextlib.contextmanager
def dry_world(P: int, Q: int, r: int, c: int):
    """The verbs of ``comm/collectives.py`` in the multi-process form as
    rank ``(r, c)`` issues them, through a transport that records nothing
    and communicates nothing: a broadcast returns this rank's value, an
    all-gather this rank's value once per line member. A real
    rank-varying verb would hang; this one only shows in the schedule."""
    from ..comm import collectives as cc

    world = _DryWorld(P, Q, r, c)

    def dry(kind, x, group, src=-1, *, pieces=None, expect=None):
        if kind == "all_gather":
            return [x.clone() for _ in range(P if group[0] == "col" else Q)]
        if kind == "broadcast":
            return x.clone()
        raise NotImplementedError(f"the dry transport has no {kind!r}")

    saved = (cc._WORLD, cc._transport)
    cc._WORLD, cc._transport = world, dry
    try:
        yield world
    finally:
        cc._WORLD, cc._transport = saved


def _rank_varying_collective(device: str = "cpu") -> List[Finding]:
    """A broadcast along the row axis that only grid row 0 issues: its
    column groups then disagree, the multi-process deadlock class
    graph-conditional-collective exists for."""
    import torch

    from ..comm import collectives as cc

    def program(xs, r):
        y = cc.all_reduce(xs, "col")
        if r == 0:
            y = cc.bcast(y, "row", 0)
        return y

    schedules = {}
    for r in range(2):
        for c in range(2):
            with dry_world(2, 2, r, c):
                xs = [[None, None], [None, None]]
                xs[r][c] = torch.full((4, 4), float(r * 2 + c), device=device)
                tape = depgraph.trace(program, xs, r, device=device, ops=False)
            schedules[(r, c)] = tape.schedule
    return graphcheck.schedule_findings(schedules, (2, 2), name="drill.rank_varying_collective")


def _host_callback(device: str = "cpu") -> List[Finding]:
    """An ``.item()`` in a step loop: the host waits for the device on
    every step."""
    import torch

    def fn(x):
        for k in range(4):
            if x[k, k].item() > 0:
                x = x * 1.5
        return x

    x = torch.eye(8, dtype=torch.float64, device=device) + 1.0
    return graphcheck.audit_tape("drill.host_callback", depgraph.trace(fn, x))


def _dropped_output(device: str = "cpu") -> List[Finding]:
    """A per-step reduction computed every step and never read: the
    eager counterpart of a dropped scan output."""
    import torch

    def fn(x):
        acc = x.clone()
        for _ in range(4):
            acc = acc * 1.5
            acc.sum()
        return acc

    x = torch.ones((8, 8), dtype=torch.float64, device=device)
    return graphcheck.audit_tape("drill.dropped_output", depgraph.trace(fn, x))


def _hbm_blowup(device: str = "cpu") -> List[Finding]:
    """A broadcast-then-reduce temporary 64x the program's input bytes."""
    import torch

    def fn(x):
        big = x.expand(64, *x.shape) * 2.0
        return big.sum(0)

    x = torch.ones((16, 16), dtype=torch.float64, device=device)
    return graphcheck.audit_tape("drill.hbm_blowup", depgraph.trace(fn, x))


def _precision_demotion(device: str = "cpu") -> List[Finding]:
    """An f64 operand silently demoted to f32 for the product."""
    import torch

    def fn(x):
        y = x.to(torch.float32)
        return (y @ y).to(torch.float64)

    x = torch.ones((8, 8), dtype=torch.float64, device=device)
    return graphcheck.audit_tape("drill.precision_demotion", depgraph.trace(fn, x))


#: Seeded-bad source for the lint drill: one violation per rule, in a path
#: under the hot layers (``dlaf_tpu_torch/algorithms/``). The bare
#: suppression on the last function is itself the violation for
#: lint-suppression-reason. (The suppression scanner reads real COMMENT
#: tokens only, so this string literal's marker is invisible when THIS
#: file is linted.) The forbidden import shares its line with ``os``: the
#: AST rule sees it where a scan of lines for ``import jax`` would not.
LINT_DRILL_PATH = "dlaf_tpu_torch/algorithms/_lint_drill.py"
LINT_DRILL_SOURCE = '''\
import os, jax

import numpy as np
import torch

from dlaf_tpu_torch import obs
from dlaf_tpu_torch.comm import collectives as cc


def resolved_bad_knob():
    return os.environ.get("DLAF_TOTALLY_UNREGISTERED_KNOB", "0")


def _cholesky_dist(lts: cc.Shards, dist):
    def step(k):
        obs.counter("dlaf_bad_steps_total", mode="bad").inc()
        return np.abs(lts[0][0])
    return step


def _bad_local(a: torch.Tensor):
    host = a.cpu()
    print("peek:", host[0, 0].item())
    return a


def suppressed_without_reason():
    return os.environ.get("DLAF_OTHER_KNOB")  # dlaf: disable=lint-unregistered-knob
'''


def _lint_violation(device: str = "cpu") -> List[Finding]:
    return lint.lint_source(LINT_DRILL_SOURCE, LINT_DRILL_PATH)


#: drill name -> (runner, rules the run MUST report)
DRILLS: Dict[str, Tuple[Callable[..., List[Finding]], Tuple[str, ...]]] = {
    "rank_varying_collective": (_rank_varying_collective,
                                ("graph-conditional-collective",)),
    "host_callback": (_host_callback, ("graph-host-callback",)),
    "dropped_output": (_dropped_output, ("graph-dead-output",)),
    "hbm_blowup": (_hbm_blowup, ("graph-hbm-blowup",)),
    "precision_demotion": (_precision_demotion, ("graph-precision-demotion",)),
    "lint_violation": (_lint_violation,
                       ("lint-unregistered-knob", "lint-unguarded-traced-metric",
                        "lint-np-in-traced", "lint-host-sync", "lint-suppression-reason",
                        "lint-forbidden-import")),
}


def run(name: str, device: str = "cpu") -> Tuple[List[Finding], Tuple[str, ...]]:
    """Run one drill on ``device``; returns (findings, rules that must
    appear)."""
    if name not in DRILLS:
        raise KeyError(f"unknown drill {name!r}; have {sorted(DRILLS)}")
    runner, expected = DRILLS[name]
    return runner(device), expected
