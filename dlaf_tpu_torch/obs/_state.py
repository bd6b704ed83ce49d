"""Shared mutable state of the observability layer.

Port of ``dlaf_tpu/obs/_state.py``. One module-level :data:`STATE` object,
mutated only by :func:`dlaf_tpu_torch.obs.configure` (driven by
``config.initialize()``) and by the lazy environment fallback for
processes that use the library without initializing the configuration.
Every hot-path check in the tracer, the metrics and the logger is a read
of one attribute here (no lock, no dict lookup), so call sites stay
allocation-free when observability is off.

The rank rule differs from the reference's: there the rank is
``jax.process_index()`` once a backend exists; here it is
``torch.distributed.get_rank()`` once a process group is initialized, and
nothing is read before that.
"""

from __future__ import annotations

import os
import sys

#: DLAF_LOG levels, lowest first. "off" silences everything.
LOG_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "off": 99}


class _ObsState:
    __slots__ = ("configured", "log_level", "log_level_num", "metrics_on",
                 "annotate", "trace_dir", "sink", "registry",
                 "profiler_started", "profiler", "atexit_registered",
                 "rank", "flight", "exporter_port", "telemetry_on", "tape")

    def __init__(self):
        self.configured = False
        self.log_level = "info"
        self.log_level_num = LOG_LEVELS["info"]
        self.metrics_on = False          # counters/spans record + JSONL sink
        self.annotate = False            # torch.profiler record_function on
        self.trace_dir = ""              # torch.profiler trace output dir
        self.sink = None                 # JsonlSink, or None
        self.registry = None             # Registry, or None
        self.profiler_started = False
        self.profiler = None             # the live torch.profiler.profile
        self.atexit_registered = False
        self.rank = None                 # pinned process rank, or None
        self.flight = None               # FlightRecorder, or None
        self.exporter_port = 0           # DLAF_METRICS_PORT in effect (0=off)
        self.telemetry_on = False        # DLAF_PROGRAM_TELEMETRY knob
        self.tape = None                 # the armed analysis.depgraph tape, or None


STATE = _ObsState()


def _warn(msg: str) -> None:
    print(f"dlaf_tpu_torch[warning] obs: {msg}", file=sys.stderr, flush=True)


def ensure_env_defaults() -> None:
    """Lazy fallback: pick up ``DLAF_LOG``, ``DLAF_METRICS_PATH``,
    ``DLAF_TRACE_DIR``, ``DLAF_PROGRAM_TELEMETRY``, ``DLAF_METRICS_PORT``
    and ``DLAF_FLIGHT_RECORDER``
    from the environment when nothing has called
    :func:`dlaf_tpu_torch.obs.configure` yet. A later configure()
    overrides this. A malformed variable warns instead of raising here
    (this path is reached from informational log calls deep inside the
    library); ``config.initialize()`` still rejects it."""
    if STATE.configured:
        return
    from . import configure

    level = os.environ.get("DLAF_LOG", "info")
    if str(level).strip().lower() not in LOG_LEVELS:
        _warn(f"DLAF_LOG={level!r} is not one of {tuple(LOG_LEVELS)}; using 'info'")
        level = "info"

    def _int_env(name):
        raw = os.environ.get(name, "").strip()
        try:
            val = int(raw) if raw else 0
        except ValueError:
            val = -1
        if val < 0:
            _warn(f"{name}={raw!r} is not a non-negative int; using 0 (off)")
            return 0
        return val

    configure(log_level=level,
              metrics_path=os.environ.get("DLAF_METRICS_PATH", ""),
              trace_dir=os.environ.get("DLAF_TRACE_DIR", ""),
              program_telemetry=os.environ.get("DLAF_PROGRAM_TELEMETRY", "").strip().lower()
              in ("1", "true", "yes", "on"),
              metrics_port=_int_env("DLAF_METRICS_PORT"),
              flight_recorder=_int_env("DLAF_FLIGHT_RECORDER"))


def current_rank():
    """The process rank for record stamping: the rank an owner pinned with
    :func:`dlaf_tpu_torch.obs.set_rank` (``initialize_multihost`` does),
    else ``torch.distributed.get_rank()`` once a process group exists.
    Nothing is imported or initialized for it: records written before a
    world exists carry no ``rank`` field (optional in the schema)."""
    if STATE.rank is not None:
        return STATE.rank
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return None
    try:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        STATE.rank = int(dist.get_rank())
    except Exception:
        return None
    return STATE.rank
