"""Program telemetry: first-call walls, key counts, device memory.

Port of ``dlaf_tpu/obs/telemetry.py``. The ``DLAF_PROGRAM_TELEMETRY`` knob
(``Configuration.program_telemetry``) arms three signals per ``site``
label, with the reference's names:

* ``dlaf_compile_seconds{site}``: histogram of the wall of each program's
  first call;
* ``dlaf_retrace_total{site}``: counter of the distinct program keys seen
  at the site (1 = one program; more = more shapes, dtypes or routes);
* ``dlaf_hbm_bytes{what=args|output|temp|peak,site}``: gauges of the
  first call's memory.

Each first call also writes two ``program`` records to the
``metrics_path`` artifact, as the reference's ``aot_compile`` does: a
``retrace`` event, then a ``compile`` event carrying ``compile_s`` and
``hbm``.

**What a program is here.** Eager PyTorch compiles nothing, so the port
defines a program the way :mod:`..serve.programs` does:

* the *program key* is ``(site, callable, arg keys, static keyword
  arguments, Route.key())``: a tensor keys on its shape, dtype, device and
  layout, a list or tuple on its members' keys, anything else on its value
  (an unhashable one leaves the call uninstrumented, as the reference
  does); ``Route.key()`` is the active autotune route
  (:func:`..autotune.routes.active`), so a route change is a new program;
* the first call under a new key is the ``compile`` event, and
  ``compile_s`` its wall, fenced on the device (``torch.cuda.synchronize``
  before and after, when an argument lies on a CUDA device). In a fresh
  process that wall includes loading the kernel library;
* ``dlaf_retrace_total{site}`` counts the distinct keys seen at a site.
  The seen keys are kept in a bounded LRU (:data:`MAX_PROGRAMS`); a key
  evicted from it and seen again counts again, as a reference program
  evicted from its cache compiles again.

**Memory formulas** (bytes, of the first call of a key):

* ``args`` = sum of ``numel * element_size`` over the tensors of the
  positional and keyword arguments (lists, tuples and dicts walked; a
  Matrix through its shards);
* ``output`` = the same sum over the return value;
* on ``cuda`` only, from the caching allocator's statistics: with ``a0``
  = ``torch.cuda.memory_allocated`` just before the call and ``P`` the
  allocator's peak during it (the peak counter reset at the call's
  start), ``rise = P - a0``, ``temp = max(rise - output, 0)`` and ``peak
  = args + max(rise, output)`` (the reference's ``args + output + temp``
  when nothing aliases). A call that frees an argument lowers ``rise`` by
  its bytes.

**The peak counter is global to the device.** ``chip_smoke.py`` and
``miniapp/peak_memory.py`` read the same counter around a whole run. To
keep that outer view whole, a first call saves the peak it is about to
reset into a per-device floor, and :func:`max_memory_allocated` returns
the larger of the allocator's peak and that floor;
:func:`reset_peak_memory_stats` clears both. Readers of a peak that may
span telemetry sites go through these two (nested sites keep a stack of
floors, so each site's peak is its own).

**Off** (the default), :func:`call` is a passthrough: one check of
:data:`._state.STATE`, no key and no record (the cost contract of
:mod:`dlaf_tpu_torch.obs`). On, a repeated call costs its key (a tuple of
shapes, no host copy) and one dict lookup: no fence after the first call.

**Dropped, and why.** ``count_retrace`` (reference ``telemetry.py:108``)
has no site: its two reference sites (``tridiag_solver.py:420,444``) are
the level-batched D&C, which the port dropped with ``dc_level_batch``.
``record_schedule`` (``:197``) reads a compiled program's HLO schedule for
``obs.critpath``: eager PyTorch compiles no program, and the port's
:mod:`.critpath` reads each kernel's step off the ``<algo>.step<k>`` range
around its launch in the profiler trace instead, so no ``schedule``
record is needed. ``memory_analysis_dict``
(``:131``) reads ``compiled.memory_analysis()``, which eager PyTorch does
not have; the allocator formulas above take its place.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple, Optional

from ._state import STATE

#: Distinct program keys remembered (LRU): a long-lived process with many
#: shapes keeps a bounded set.
MAX_PROGRAMS = 4096

_SEEN: dict = {}            # program key -> None, insertion order = recency
_LOCK = threading.Lock()
_FLOOR: dict = {}           # cuda device index -> peak saved before a reset


def active() -> bool:
    """Fast-path gate (one attribute read) for instrumented sites."""
    return STATE.telemetry_on


def _registry():
    if STATE.registry is None:
        from .metrics import Registry

        STATE.registry = Registry()
    return STATE.registry


class AotProgram(NamedTuple):
    """Result of :func:`aot_compile`: the program (the callable itself:
    nothing is compiled), its first call's output, the wall of that call
    and its memory (:func:`call`'s formulas)."""

    compiled: Any
    output: Any
    compile_s: float
    memory: dict


def _tensors(x, out: list) -> list:
    """The tensors of ``x`` (walking lists, tuples, dicts and a Matrix's
    shards), appended to ``out``."""
    import torch

    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif hasattr(x, "shards") and hasattr(x, "dist"):
        _tensors(x.shards(), out)
    return out


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x, [])))


def _arg_key(x):
    """A tensor keys on (shape, dtype, device, layout), a list or tuple on
    its members' keys, anything else on its value."""
    import torch

    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.dtype, x.device, x.layout)
    if isinstance(x, (list, tuple)):
        return tuple(_arg_key(v) for v in x)
    return x


def _cuda_device(args, kwargs):
    """The device of the first CUDA tensor among the arguments, or None."""
    for t in _tensors((args, kwargs), []):
        if t.is_cuda:
            return t.device
    return None


def _route_key() -> tuple:
    from ..autotune.routes import active as route

    r = route()
    return () if r is None else r.key()


def record_compile(site: str, *, compile_s: float, memory: Optional[dict] = None,
                   **attrs) -> None:
    """Record one program: the ``dlaf_retrace_total`` increment and its
    ``retrace`` record, the compile-seconds histogram, the memory gauges
    and the ``compile`` record. No-op when the knob is off."""
    if not STATE.telemetry_on:
        return
    reg = _registry()
    reg.counter("dlaf_retrace_total", site=site).inc()
    reg.histogram("dlaf_compile_seconds", site=site).observe(compile_s)
    for what in ("args", "output", "temp", "peak"):
        if memory and what in memory:
            reg.gauge("dlaf_hbm_bytes", what=what, site=site).set(memory[what])
    if STATE.sink is not None:
        STATE.sink.write({"type": "program", "site": site, "event": "retrace", "attrs": {}})
        rec = {"type": "program", "site": site, "event": "compile",
               "compile_s": float(compile_s), "attrs": dict(attrs)}
        if memory:
            rec["hbm"] = {k: float(v) for k, v in memory.items()}
        STATE.sink.write(rec)


def _measured(fn, args, kwargs, allocator: bool = True):
    """``(output, wall s, memory dict)`` of one fenced call of ``fn``; the
    allocator's statistics (``temp``, ``peak``) only with ``allocator``."""
    import torch

    dev = _cuda_device(args, kwargs)
    memory = {"args": _nbytes((args, kwargs))}
    if dev is None or not allocator:
        if dev is not None:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev is not None:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        memory["output"] = _nbytes(out)
        return out, wall, memory
    idx = _index(dev)
    torch.cuda.synchronize(dev)
    # the outer view: the peak about to be reset is kept in the floor, and
    # this call's own peak is read against a cleared floor (nested sites)
    saved = max(_FLOOR.pop(idx, 0), torch.cuda.max_memory_allocated(dev))
    a0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        p = max(torch.cuda.max_memory_allocated(dev), _FLOOR.get(idx, 0))
    finally:
        _FLOOR[idx] = max(saved, _FLOOR.get(idx, 0), torch.cuda.max_memory_allocated(dev))
    rise = max(p - a0, 0)
    memory["output"] = _nbytes(out)
    memory["temp"] = float(max(rise - memory["output"], 0))
    memory["peak"] = memory["args"] + float(max(rise, memory["output"]))
    return out, wall, memory


def aot_compile(site: str, fn, *args, **kwargs) -> AotProgram:
    """One fenced first call of ``fn(*args, **kwargs)`` with its wall and
    memory: the wall always measured (it is an explicit call), the
    allocator's statistics (which reset the device's peak counter) and the
    records only when the knob is on. The serve layer's bucket "compile"
    goes through it."""
    out, wall, memory = _measured(fn, args, kwargs, allocator=STATE.telemetry_on)
    record_compile(site, compile_s=wall, memory=memory)
    return AotProgram(fn, out, wall, memory)


def call(site: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` with program telemetry.

    Knob off: ``fn(*args, **kwargs)``, one attribute read of cost. Knob
    on: the first call of each program key (module docstring) is fenced
    and recorded; later calls of the key run as they are."""
    if not STATE.telemetry_on:
        return fn(*args, **kwargs)
    try:
        key = (site, fn, tuple(_arg_key(a) for a in args),
               tuple(sorted((k, _arg_key(v)) for k, v in kwargs.items())), _route_key())
        hash(key)
    except TypeError:
        return fn(*args, **kwargs)      # an unhashable static: uninstrumented
    with _LOCK:
        if key in _SEEN:
            _SEEN[key] = _SEEN.pop(key)     # recency
            seen = True
        else:
            while len(_SEEN) >= MAX_PROGRAMS:
                _SEEN.pop(next(iter(_SEEN)))
            _SEEN[key] = None
            seen = False
    if seen:
        return fn(*args, **kwargs)
    out, wall, memory = _measured(fn, args, kwargs)
    record_compile(site, compile_s=wall, memory=memory,
                   **({"route": dict(key[-1])} if key[-1] else {}))
    return out


def _index(device) -> int:
    """The CUDA device index of ``device`` (None: the current device)."""
    import torch

    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def max_memory_allocated(device=None) -> int:
    """The allocator's peak on ``device`` since the last
    :func:`reset_peak_memory_stats`, telemetry's resets included (module
    docstring): ``torch.cuda.max_memory_allocated`` or the floor a first
    call saved, whichever is larger."""
    import torch

    idx = _index(device)
    return max(torch.cuda.max_memory_allocated(idx), _FLOOR.get(idx, 0))


def reset_peak_memory_stats(device=None) -> None:
    """``torch.cuda.reset_peak_memory_stats`` and the telemetry floor of
    ``device``."""
    import torch

    idx = _index(device)
    _FLOOR.pop(idx, None)
    torch.cuda.reset_peak_memory_stats(idx)


def _reset_for_tests() -> None:
    with _LOCK:
        _SEEN.clear()
    _FLOOR.clear()
