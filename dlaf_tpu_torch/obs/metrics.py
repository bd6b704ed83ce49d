"""Metrics registry: counters, gauges, histograms + Prometheus exposition.

Port of ``dlaf_tpu/obs/metrics.py``: pure Python, so the exposition text
of the same operations is byte for byte the reference's. Semantics:

* **Counter** — monotone accumulator (``inc``). Collective counts/bytes,
  tile-op counts.
* **Gauge** — last-write-wins scalar (``set``).
* **Histogram** — count/sum/min/max plus cumulative bucket counts over
  fixed upper bounds (powers of two by default, Prometheus ``le``
  convention). Span durations.

Handles are cheap objects bound to their registry slot: call sites fetch
them via :func:`Registry.counter` etc. (get-or-create keyed on
``(kind, name, labels)``). The module-level no-op twins (``NOOP_COUNTER``
...) are what :mod:`dlaf_tpu_torch.obs` hands out when observability is off —
method calls on them do nothing and allocate nothing.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

#: Default histogram upper bounds: powers of two from 1 us to ~17 min,
#: in seconds — span durations from tile ops to whole-pipeline runs.
DEFAULT_BUCKETS = tuple(2.0 ** e for e in range(-20, 11))


def _quantile_sorted(vals, q: float) -> float:
    """Linear-interpolated q-quantile of an ALREADY-SORTED non-empty
    list (:func:`quantile` has the contract; :func:`quantiles` shares
    the sort across several q)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile: q={q} must be in [0, 1]")
    pos = (len(vals) - 1) * float(q)
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    a, b = vals[lo], vals[hi]
    t = pos - lo
    # numpy's _lerp: the t >= 0.5 branch anchors on b so the two ends
    # are exact and the result is monotone — mirrored here so the
    # equality pin holds to the bit, not just approximately
    return b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t


def quantile(values, q: float) -> float:
    """The q-quantile (q in [0, 1]) of ``values`` with numpy's default
    linear interpolation — bit-identical to ``np.quantile(values, q)``
    on the same sample, so the rolling SLO window and any offline
    report of the same latencies give THE SAME p99. NaN for an empty
    sample."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return float("nan")
    return _quantile_sorted(vals, q)


def quantiles(values, qs) -> list:
    """Several quantiles of the same sample with ONE sort (the
    per-observation SLO gauge refresh asks for p50/p95/p99 together —
    three independent :func:`quantile` calls would sort the window
    three times). NaN-filled for an empty sample."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return [float("nan")] * len(qs)
    return [_quantile_sorted(vals, q) for q in qs]


class SlidingWindow:
    """Rolling-window sample store for latency quantiles:
    a ring of ``epochs`` fixed-capacity epoch buckets, each covering
    ``window_s / epochs`` seconds of the injectable ``clock``. A sample
    lands in the current epoch's bucket; an epoch older than the window
    is overwritten when its ring slot comes around again and excluded
    from :meth:`samples` meanwhile — memory is bounded at
    ``epochs * cap`` floats regardless of traffic, and behavior is a
    pure function of the (clock, observe) sequence, so tests drive it
    deterministically with a fake clock. Overflow beyond ``cap`` samples
    per epoch is dropped and counted (:attr:`dropped`) — visibly, never
    silently reweighted."""

    __slots__ = ("window_s", "epochs", "cap", "clock", "dropped",
                 "_epoch_len", "_ring", "_stamps", "_lock")

    def __init__(self, window_s: float = 60.0, epochs: int = 6,
                 cap: int = 256, clock=time.monotonic, lock=None):
        if not window_s > 0 or epochs < 1 or cap < 1:
            raise ValueError("SlidingWindow: window_s > 0, epochs >= 1, "
                             f"cap >= 1 required (got {window_s}, {epochs},"
                             f" {cap})")
        self.window_s = float(window_s)
        self.epochs = int(epochs)
        self.cap = int(cap)
        self.clock = clock
        self.dropped = 0
        self._epoch_len = self.window_s / self.epochs
        self._ring = [[] for _ in range(self.epochs)]
        self._stamps = [None] * self.epochs
        self._lock = lock or threading.Lock()

    def _epoch(self) -> int:
        return int(self.clock() // self._epoch_len)

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            e = self._epoch()
            slot = e % self.epochs
            if self._stamps[slot] != e:
                self._ring[slot] = []       # the slot's old epoch expired
                self._stamps[slot] = e
            if len(self._ring[slot]) < self.cap:
                self._ring[slot].append(v)
            else:
                self.dropped += 1

    def samples(self) -> list:
        """All samples still inside the window (live epochs only)."""
        with self._lock:
            e = self._epoch()
            out = []
            for slot in range(self.epochs):
                stamp = self._stamps[slot]
                if stamp is not None and 0 <= e - stamp < self.epochs:
                    out.extend(self._ring[slot])
            return out

    def count(self) -> int:
        return len(self.samples())

    def quantile(self, q: float) -> float:
        """Windowed q-quantile (numpy-linear, :func:`quantile`); NaN when
        the window is empty."""
        return quantile(self.samples(), q)


class Counter:
    __slots__ = ("name", "labels", "value", "lock")

    def __init__(self, name: str, labels: dict, lock=None):
        self.name = name
        self.labels = labels
        self.value = 0.0
        # the owning registry shares its lock so mutation excludes
        # snapshot(); spans run on arbitrary threads (trace.py keeps a
        # per-thread span stack) and bare ``+=`` would lose increments
        self.lock = lock or threading.Lock()

    def inc(self, n=1) -> None:
        with self.lock:
            self.value += n

    def snapshot(self) -> dict:
        # callers serialize via the registry lock (Registry.snapshot)
        return {"name": self.name, "kind": "counter", "labels": self.labels,
                "value": self.value}


class Gauge:
    __slots__ = ("name", "labels", "value", "lock")

    def __init__(self, name: str, labels: dict, lock=None):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self.lock = lock or threading.Lock()

    def set(self, v) -> None:
        v = float(v)
        with self.lock:
            self.value = v

    def snapshot(self) -> dict:
        return {"name": self.name, "kind": "gauge", "labels": self.labels,
                "value": self.value}


class Histogram:
    __slots__ = ("name", "labels", "bounds", "bucket_counts", "count",
                 "sum", "min", "max", "lock", "window", "exemplars")

    def __init__(self, name: str, labels: dict, bounds=DEFAULT_BUCKETS,
                 lock=None):
        self.name = name
        self.labels = labels
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.lock = lock or threading.Lock()
        self.window = None       # optional SlidingWindow (windowed())
        self.exemplars = {}      # bucket index -> [trace_id, value]

    def windowed(self, window_s: Optional[float] = None,
                 epochs: int = 6, cap: int = 256,
                 clock=time.monotonic) -> SlidingWindow:
        """The histogram's attached rolling-window quantile estimator
        (created on first call; later calls return the SAME window and
        ignore the sizing arguments — one window per series). Every
        subsequent :meth:`observe` feeds it alongside the cumulative
        buckets; the window has its OWN lock (it is also read from
        scrape threads) and bounded memory (class docstring)."""
        with self.lock:
            if self.window is None:
                self.window = SlidingWindow(
                    window_s if window_s is not None else 60.0,
                    epochs=epochs, cap=cap, clock=clock)
            return self.window

    def observe(self, v) -> None:
        v = float(v)
        # exemplar: attribute this observation to the active REQUEST
        # trace when there is exactly one (batch-scope contexts carry a
        # list and are never exemplars) — resolved before taking the
        # lock, one ContextVar read when no context is live
        from .context import single_trace_id

        tid = single_trace_id()
        with self.lock:
            # count/sum/buckets move together, or a concurrent snapshot
            # breaks the Prometheus invariant bucket{le="+Inf"} == count
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            slot = len(self.bounds)
            for i, b in enumerate(self.bounds):
                if v <= b:
                    slot = i
                    break
            self.bucket_counts[slot] += 1
            if tid is not None:
                self.exemplars[slot] = [tid, v]
        if self.window is not None:
            # outside the registry lock: the window owns its own lock
            # (a shared non-reentrant lock would deadlock here)
            self.window.observe(v)

    def cumulative_buckets(self):
        """Prometheus-convention cumulative ``[le, count]`` pairs, the
        final one ``["+Inf", count]``."""
        out, acc = [], 0
        for b, c in zip(self.bounds, self.bucket_counts):
            acc += c
            out.append([b, acc])
        out.append(["+Inf", acc + self.bucket_counts[-1]])
        return out

    def snapshot(self) -> dict:
        snap = {"name": self.name, "kind": "histogram",
                "labels": self.labels,
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "buckets": self.cumulative_buckets()}
        if self.exemplars:
            # keyed by bucket INDEX (matching the cumulative list's
            # positions, +Inf last) so exposition can attach each
            # exemplar to its bucket line
            snap["exemplars"] = {i: list(ex)
                                 for i, ex in self.exemplars.items()}
        return snap


class _NoopCounter:
    __slots__ = ()

    def inc(self, n=1) -> None:
        pass


class _NoopGauge:
    __slots__ = ()

    def set(self, v) -> None:
        pass


class _NoopWindow:
    __slots__ = ()

    def observe(self, v) -> None:
        pass

    def samples(self) -> list:
        return []

    def count(self) -> int:
        return 0

    def quantile(self, q) -> float:
        return float("nan")


class _NoopHistogram:
    __slots__ = ()

    def observe(self, v) -> None:
        pass

    def windowed(self, *args, **kwargs):
        return NOOP_WINDOW


#: Singletons the facade returns when observability is off: no state, no
#: per-call allocation (the acceptance criterion's no-op fast path).
NOOP_COUNTER = _NoopCounter()
NOOP_GAUGE = _NoopGauge()
NOOP_HISTOGRAM = _NoopHistogram()
NOOP_WINDOW = _NoopWindow()


def _labels_key(labels: dict):
    return tuple(sorted(labels.items()))


class Registry:
    """Get-or-create metric store keyed on ``(kind, name, labels)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, kind, cls, name, labels, **kw):
        key = (kind, name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    # metrics share the registry lock: snapshot() holds it,
                    # so no update can tear a histogram mid-serialization
                    m = cls(name, labels, lock=self._lock, **kw)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, bounds: Optional[tuple] = None,
                  **labels) -> Histogram:
        kw = {"bounds": bounds} if bounds is not None else {}
        return self._get("histogram", Histogram, name, labels, **kw)

    def snapshot(self) -> list:
        with self._lock:
            return [m.snapshot() for m in self._metrics.values()]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    # text exposition 0.0.4 label escaping: backslash, double-quote, and
    # line feed (an unescaped newline would split the sample line)
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"').replace("\n", "\\n"))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(snapshot: list, exemplars: bool = False) -> str:
    """Prometheus text exposition (format 0.0.4) of a registry snapshot
    (the list :func:`Registry.snapshot` returns).

    ``exemplars=True`` additionally appends OpenMetrics-style exemplars
    to histogram bucket lines that carry one —
    ``name_bucket{le="0.25"} 7 # {trace_id="3f2a..."} 0.21`` — joining a
    latency bucket to ONE request's trace ID. Off by default: the classic 0.0.4 grammar has no
    exemplar clause, so artifacts and the ``--prom`` CLI stay exactly as
    before; the live ``/metrics`` endpoint opts in."""
    by_name: dict = {}
    for m in snapshot:
        by_name.setdefault((m["name"], m["kind"]), []).append(m)
    lines = []
    for (name, kind), entries in sorted(by_name.items()):
        lines.append(f"# TYPE {name} {kind}")
        # deterministic series order within a family: sorted by labels,
        # not by registry insertion order (two runs of the same program
        # must scrape identically — diffs in CI artifacts stay readable)
        entries = sorted(entries,
                         key=lambda m: sorted(m.get("labels", {}).items()))
        for m in entries:
            labels = m.get("labels", {})
            if kind == "histogram":
                ex = m.get("exemplars") or {} if exemplars else {}
                for i, (le, cnt) in enumerate(m["buckets"]):
                    lb = dict(labels)
                    lb["le"] = le if isinstance(le, str) else _prom_num(le)
                    line = f"{name}_bucket{_prom_labels(lb)} {cnt}"
                    hit = ex.get(i, ex.get(str(i)))
                    if hit:
                        tid, v = hit
                        line += (' # {trace_id="%s"} %s'
                                 % (tid, _prom_num(float(v))))
                    lines.append(line)
                lines.append(f"{name}_sum{_prom_labels(labels)} "
                             f"{_prom_num(m['sum'])}")
                lines.append(f"{name}_count{_prom_labels(labels)} "
                             f"{m['count']}")
            else:
                lines.append(f"{name}{_prom_labels(labels)} "
                             f"{_prom_num(m['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")
