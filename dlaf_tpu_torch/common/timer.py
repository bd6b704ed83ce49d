"""Wall-clock timing and phase timing.

Port of ``dlaf_tpu/common/timer.py:21-115`` (reference ``common::Timer``):
:class:`Timer` and :class:`PhaseTimer`, whose named phases sum their walls
into :meth:`PhaseTimer.report`. Each phase is an :mod:`..obs` span (a
JSONL record and a duration histogram with ``DLAF_METRICS_PATH``, a
profiler-timeline name with a trace directory). A caller that wants a
phase to time the device's work ends it with
:func:`..common.sync.hard_fence` on the phase's outputs, as the
eigensolver does when it is given a PhaseTimer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from .. import obs


class Timer:
    """Elapsed-seconds timer (reference ``common::Timer``)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class PhaseTimer:
    """Named phase walls of a multi-stage algorithm: ``with
    timer.phase("stage.reduction_to_band"): ...``; a repeated name adds
    up. ``report()`` returns ``{name: seconds}`` in first-seen order.

    Phases are obs spans; per-call context goes in attrs, so one name
    keeps one histogram. With ``profile_dir`` a ``torch.profiler`` trace
    runs into that directory from the first phase to :meth:`stop`, even
    with the obs layer off, through the layer's single-owner protocol
    (:func:`..obs.start_profiler`); when the obs layer has a trace
    directory of its own, that one wins and a warning says so."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.times: dict[str, float] = {}
        self.profile_dir = profile_dir
        self._tracing = False

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        from ..obs._state import STATE

        ann = contextlib.nullcontext()
        if self.profile_dir is not None and STATE.trace_dir \
                and STATE.trace_dir != self.profile_dir:
            # one profiler per process: the obs layer's trace dir wins
            obs.get_logger("timer").warning_once(
                ("profile_dir_superseded", self.profile_dir),
                f"profile_dir={self.profile_dir!r} superseded by "
                f"DLAF_TRACE_DIR={STATE.trace_dir!r}; the trace lands there",
                profile_dir=self.profile_dir, trace_dir=STATE.trace_dir)
        if self.profile_dir is not None and not STATE.trace_dir:
            if not self._tracing and obs.start_profiler(self.profile_dir):
                self._tracing = True
            # the obs span does not annotate (no obs trace dir): name the
            # phase on the profiler timeline here
            import torch

            ann = torch.profiler.record_function(name)
        sp = obs.span(name, **attrs)
        with sp, ann:
            # t0 after span entry: the profiler's start stays out of the
            # phase's seconds
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def stop(self):
        """End the trace this timer owns (or that the obs layer runs into
        ``profile_dir`` on its behalf) and write it; returns the trace
        file's path, or None."""
        from ..obs._state import STATE

        if self._tracing:
            self._tracing = False
            return obs.stop_profiler()
        if self.profile_dir is not None and STATE.trace_dir == self.profile_dir:
            return obs.stop_profiler()
        return None

    def report(self) -> dict[str, float]:
        return dict(self.times)
