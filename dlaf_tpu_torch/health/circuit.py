"""Circuit breakers: stop hammering a failing site.

Port of ``dlaf_tpu/health/circuit.py`` (docs/robustness.md §3). A retry
policy protects one call; a breaker protects the SITE across calls: the
N-th consecutive failure turns later calls into fast rejections until a
cooldown lets one probe through.

    closed --(threshold consecutive failures)--> open
    open --(cooldown elapsed; ONE probe admitted)--> half_open
    half_open --probe success--> closed
    half_open --probe failure--> open  (cooldown restarts)

``allow()`` raises :class:`.errors.CircuitOpenError` when the breaker
rejects; ``record_success``/``record_failure`` feed outcomes back. Any
success fully closes it. One lock per breaker; in ``half_open`` exactly
one in-flight probe is admitted. Defaults come from the config knobs
``circuit_threshold``/``circuit_cooldown_s``; the ``clock`` is injectable.
The process registry (:func:`breaker`) keys breakers by site; the serving
queue uses one per bucket program.

Every transition sets the ``dlaf_circuit_state{site}`` gauge (0 closed, 1
half_open, 2 open) and writes a ``resilience`` record (``circuit_open``,
``circuit_half_open``, ``circuit_close``); an opening trips the flight
recorder (``breaker_open``), as the reference's (``circuit.py:92-163``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from .. import obs
from .errors import CircuitOpenError

#: Gauge of each breaker's state (labels: site).
CIRCUIT_GAUGE = "dlaf_circuit_state"

#: Gauge values (also the ``state()`` -> value mapping).
STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}

_EVENTS = {"closed": "circuit_close", "half_open": "circuit_half_open",
           "open": "circuit_open"}

class CircuitBreaker:
    """One site's breaker (module docstring)."""

    def __init__(self, site: str, *, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..config import get_configuration

        cfg = get_configuration()
        self.site = str(site)
        self.threshold = int(threshold if threshold is not None else cfg.circuit_threshold)
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else cfg.circuit_cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_live = False

    def state(self) -> str:
        """"closed" | "half_open" | "open" (point in time: an elapsed
        cooldown still reads "open" until a caller's allow() admits the
        probe)."""
        with self._lock:
            return self._state

    def _set(self, state: str) -> None:
        """Transition (lock held): gauge and resilience record. The flight
        dump an opening owes is the caller's, after the lock is released
        (it is file I/O)."""
        if state == self._state:
            return
        self._state = state
        obs.gauge(CIRCUIT_GAUGE, site=self.site).set(float(STATE_VALUES[state]))
        obs.emit_event("resilience", site=self.site, event=_EVENTS[state],
                       attrs={"consecutive": self._consecutive})

    def allow(self) -> None:
        """Admit or reject one call: raises :class:`CircuitOpenError` when
        open (cooldown pending) or when a half-open probe is in flight;
        admits exactly one probe once the cooldown elapses."""
        with self._lock:
            if self._state == "closed":
                return
            now = self.clock()
            if self._state == "open":
                remaining = self.cooldown_s - (now - self._opened_at)
                if remaining > 0:
                    raise CircuitOpenError(self.site, retry_in_s=remaining)
                self._set("half_open")
                self._probe_live = True
                return          # this caller IS the probe
            if self._probe_live:
                raise CircuitOpenError(self.site, retry_in_s=0.0)
            self._probe_live = True

    def record_success(self) -> None:
        """A call succeeded: any state fully closes."""
        with self._lock:
            self._consecutive = 0
            self._probe_live = False
            self._set("closed")

    def record_failure(self) -> None:
        """A call failed: a half-open probe failure re-opens (cooldown
        restarts); the threshold-th consecutive closed-state failure
        opens. An opening trips the flight recorder (``breaker_open``)
        after the lock is released, so the dump holds the opening's own
        record."""
        opened = False
        with self._lock:
            self._consecutive += 1
            if self._state == "half_open":
                self._probe_live = False
                self._opened_at = self.clock()
                self._set("open")
                opened = True
            elif self._state == "closed" and self._consecutive >= self.threshold:
                self._opened_at = self.clock()
                self._set("open")
                opened = True
            consecutive = self._consecutive
        if opened:
            from ..obs import flight

            flight.trigger("breaker_open", site=self.site, consecutive=consecutive)

    def reset(self) -> None:
        """Force-close."""
        with self._lock:
            self._consecutive = 0
            self._probe_live = False
            self._set("closed")


_BREAKERS: Dict[str, CircuitBreaker] = {}
_REG_LOCK = threading.Lock()


def breaker(site: str, **kwargs) -> CircuitBreaker:
    """The process breaker for ``site``, created on first use. Later
    calls ignore ``threshold``/``cooldown_s`` (the first creation wins),
    but an explicitly passed ``clock`` rebinds: the active caller drives
    time, so a breaker created under one queue's test clock cannot wedge
    a later caller's cooldown."""
    with _REG_LOCK:
        br = _BREAKERS.get(site)
        if br is None:
            br = _BREAKERS[site] = CircuitBreaker(site, **kwargs)
        elif "clock" in kwargs:
            br.clock = kwargs["clock"]
        return br


def peek(site: str) -> Optional[str]:
    """``site``'s state without creating a breaker (None = never used)."""
    with _REG_LOCK:
        br = _BREAKERS.get(site)
    return br.state() if br is not None else None


def states() -> dict:
    """``{site: state}`` for every registered breaker, sorted by site."""
    with _REG_LOCK:
        live = sorted(_BREAKERS.items())
    return {site: br.state() for site, br in live}


def reset(prefix: Optional[str] = None) -> int:
    """Close and drop registered breakers (all, or those whose site
    starts with ``prefix``); returns how many were dropped."""
    with _REG_LOCK:
        sites = [s for s in _BREAKERS if prefix is None or s.startswith(prefix)]
        dropped = [_BREAKERS.pop(s) for s in sites]
    for br in dropped:
        br.reset()
    return len(dropped)
