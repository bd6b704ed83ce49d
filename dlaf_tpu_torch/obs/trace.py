"""Span-based tracer: nested host-side spans and profiler-timeline names.

Port of ``dlaf_tpu/obs/trace.py``. A span measures host wall clock around
a region (an algorithm entry, a pipeline stage, a timed miniapp run) and
writes one ``span`` record; when a trace directory is configured it also
enters ``torch.profiler.record_function`` so the profiler's timeline
carries the same name.

The reference names its per-step phases at TRACE time (``named_span`` is
a ``jax.named_scope``, free at run time, landing in the compiled
program's op metadata). Eager PyTorch has no trace, so here
:func:`named_span` and :func:`scoped_step` write no record and enter
``record_function(name)`` only when a profiler is armed (``trace_dir``
set, ``STATE.annotate``): the one place a span costs host time per step,
which the metrics-only state does not pay. The profiler then attributes
every kernel launched inside the range to its name (``gpu_user_annotation``
on the device timeline of the Chrome trace). While an analysis tape is
armed (``STATE.tape``, :mod:`..analysis.depgraph`) the same names scope
the ops it records, and :func:`kernel_node` makes each hand kernel's
launch one node of it; with neither armed each site costs one check.

Nesting is tracked per thread; each span record carries its ``depth`` and
``parent``. Spans given ``flops`` derive GFlop/s at exit when ``fenced``:
the region ended after a device fence, so its wall is the device's work.
CUDA launches are asynchronous, so the algorithm entry spans are
``fenced=False`` (they carry flops, never gflops); a span never adds a
``torch.cuda.synchronize`` of its own.

When observability is off, :func:`span`, :func:`entry_span` and
:func:`named_span` return module-level no-op singletons: no per-call
allocation.
"""

from __future__ import annotations

import functools
import os
import threading
import time

from ._state import STATE, current_rank


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value) -> None:
        pass


#: Singletons for the disabled fast path. NOOP_CTX doubles as the
#: named_span no-op.
NOOP_SPAN = _NoopSpan()
NOOP_CTX = NOOP_SPAN

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _record_function(name: str):
    import torch

    return torch.profiler.record_function(name)


class Span:
    """Reentrant context manager: one Span object per region entry (the
    same name may be nested or repeated freely)."""

    __slots__ = ("name", "attrs", "flops", "fenced", "t0", "dur_s", "depth",
                 "parent", "_ann")

    def __init__(self, name: str, flops=None, fenced=True, **attrs):
        self.name = name
        self.attrs = attrs
        self.flops = flops
        self.fenced = fenced
        self.t0 = None
        self.dur_s = None
        self._ann = None

    def set_attr(self, key, value) -> None:
        """Attach/override an attribute after entry (e.g. a route resolved
        mid-region)."""
        self.attrs[key] = value

    def __enter__(self):
        st = _stack()
        self.depth = len(st)
        self.parent = st[-1].name if st else None
        st.append(self)
        if STATE.annotate:
            _maybe_start_profiler()
            self._ann = _record_function(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur_s = time.perf_counter() - self.t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:       # exotic exit order; keep the stack sane
            st.remove(self)
        self._emit()
        return False

    def _emit(self) -> None:
        if STATE.registry is not None:
            STATE.registry.histogram("dlaf_span_seconds",
                                     span=self.name).observe(self.dur_s)
        if STATE.sink is None:
            return
        rec = {"type": "span", "name": self.name, "dur_s": self.dur_s,
               "depth": self.depth, "parent": self.parent,
               "attrs": self.attrs}
        if not self.fenced:
            rec["fenced"] = False
        if self.flops is not None:
            rec["flops"] = float(self.flops)
            # derive GFlop/s only when the region's wall is the device's
            # work (fenced): an unfenced span around asynchronous launches
            # would report launch time as throughput
            if self.fenced and self.dur_s > 0:
                rec["gflops"] = float(self.flops) / self.dur_s / 1e9
        STATE.sink.write(rec)


def span(name: str, flops=None, fenced=True, **attrs):
    """A host-side span, or the no-op singleton when observability is off.

    ``flops``: flop count of the region; the record then carries derived
    ``gflops`` (only when ``fenced``; a region that does not end on a
    device fence passes ``fenced=False`` and keeps the flop model without
    a launch-time throughput). Other keyword arguments become attrs.
    """
    if not (STATE.metrics_on or STATE.annotate):
        return NOOP_SPAN
    return Span(name, flops=flops, fenced=fenced, **attrs)


def entry_span(name: str, attrs_fn):
    """Algorithm-entry span: unfenced (the library launches asynchronous
    work; device completion is the caller's fence, so no derived gflops),
    with lazily built attrs: ``attrs_fn`` is a zero-argument callable
    returning the attr dict (``flops`` allowed as a key), never called
    when observability is off."""
    if not (STATE.metrics_on or STATE.annotate):
        return NOOP_SPAN
    kw = dict(attrs_fn())
    return Span(name, flops=kw.pop("flops", None), fenced=False, **kw)


def named_span(name: str, *args):
    """Per-step phase name: ``torch.profiler.record_function(name % args)``
    (``name`` itself without ``args``) when a profiler is armed
    (``trace_dir``), and the innermost scope of every op that an armed
    analysis tape (:mod:`..analysis.depgraph`) records inside it; else the
    no-op singleton. The name is formatted only when one of the two is
    armed, so a step's site costs one check when both are off. Writes no
    record (the reference's is a trace-time ``jax.named_scope``)."""
    if not (STATE.annotate or STATE.tape):
        return NOOP_CTX
    label = name % args if args else name
    tape = STATE.tape
    if not STATE.annotate:
        return tape.scope(label)
    _maybe_start_profiler()
    ranged = _record_function(label)
    return ranged if tape is None else _Both(ranged, tape.scope(label))


class _Both:
    """A profiler range and a tape scope entered together."""

    __slots__ = ("outer", "inner")

    def __init__(self, outer, inner):
        self.outer, self.inner = outer, inner

    def __enter__(self):
        self.outer.__enter__()
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        self.outer.__exit__(*exc)
        return False


def scoped_step(name: str, fn):
    """``fn`` wrapped so each call runs inside ``named_span(name)``: the
    step body of a scan form, whose name carries no step index (the
    reference's scan body is traced once for every iteration). ``fn``
    itself when neither a profiler nor a tape is armed."""
    if not (STATE.annotate or STATE.tape):
        return fn

    def wrapped(*args, **kwargs):
        with named_span(name):
            return fn(*args, **kwargs)

    return wrapped


def kernel_node(launches: dict, key: str):
    """Decorator for a hand kernel's wrapper: while an analysis tape is
    armed, each outermost call becomes one ``kernel:<key>`` node reading
    its tensor arguments and writing its results (on the CPU the plain
    version's ops nest under it; on the card a call that did not add to
    ``launches[key]`` is a node marked not launched). One check per call
    otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def node(*args, **kwargs):
            if STATE.tape is None:
                return fn(*args, **kwargs)
            return STATE.tape.kernel(key, fn, args, kwargs, launches)
        return node
    return wrap


def current_span():
    """Innermost live Span of this thread, or None."""
    st = _stack()
    return st[-1] if st else None


#: Throwaway launches made on the card right after a trace starts. Late
#: in a long-lived process the profiler has dropped the device records of
#: the first launches after its start, however long after it they came
#: (on an H100, up to the first step's panel of a dist-L call); these
#: take that loss instead of the traced work. ``devtrace``'s
#: ``lost_launches`` counts what the traced ranges lost.
PRIME_LAUNCHES = 256


def start_profiler(path: str) -> bool:
    """Start THE process-wide ``torch.profiler`` trace (CPU activity, and
    CUDA where a card is present) into directory ``path`` unless some
    owner (an obs span through ``trace_dir``, or a
    ``PhaseTimer(profile_dir=...)``) already did; returns whether this
    call started it. ``STATE.profiler_started`` is the ownership protocol:
    every start and stop goes through here and :func:`stop_profiler`."""
    if STATE.profiler_started:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    if torch.cuda.is_available():
        x = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(PRIME_LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize()
    STATE.profiler = (prof, path)
    STATE.profiler_started = True
    return True


def _maybe_start_profiler() -> None:
    """Start the process trace when a trace dir is configured; stopped by
    :func:`stop_profiler` (registered at exit by configure)."""
    if STATE.trace_dir and not STATE.profiler_started:
        start_profiler(STATE.trace_dir)


def stop_profiler():
    """Stop the process trace and write its Chrome trace into the trace's
    directory, one file per process (``dlaf_trace.r<rank>.p<pid>.json``,
    or ``dlaf_trace.p<pid>.json`` before a rank is known); returns the
    file's path (None when no trace was live). The trace config retires
    with it: the next span in a long-lived process does not silently
    start a new trace; a fresh configure(trace_dir=...) re-arms it."""
    if not STATE.profiler_started:
        return None
    prof, path = STATE.profiler
    STATE.profiler = None
    STATE.profiler_started = False
    STATE.trace_dir = ""
    STATE.annotate = False
    prof.stop()
    rank = current_rank()
    tag = f"r{rank}.p{os.getpid()}" if rank is not None else f"p{os.getpid()}"
    out = os.path.join(path, f"dlaf_trace.{tag}.json")
    prof.export_chrome_trace(out)
    return out
