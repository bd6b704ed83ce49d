"""Wall-clock timing and phase timing.

Port of ``dlaf_tpu/common/timer.py:21-115`` (reference ``common::Timer``):
:class:`Timer` and :class:`PhaseTimer`, whose named phases sum their walls
into :meth:`PhaseTimer.report`. A caller that wants a phase to time the
device's work ends it with :func:`..common.sync.hard_fence` on the
phase's outputs, as the eigensolver does when it is given a PhaseTimer.
The reference's ``obs`` spans and ``profile_dir`` trace wait for the
telemetry port.
"""

from __future__ import annotations

import contextlib
import time


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
    up. ``report()`` returns ``{name: seconds}`` in first-seen order."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(self.times)
