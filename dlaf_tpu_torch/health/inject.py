"""Deterministic, seeded fault injection (tests and drills).

Port of ``dlaf_tpu/health/inject.py``: every degradation path of the port
can be driven end to end without breaking a real component.

* :func:`nan_tile`: a copy of a Matrix with one (seeded or chosen) element
  of one tile set to NaN; the same seed picks the same tile and element as
  the reference's.
* :func:`corrupt_collective`: poisons the payload of ONE collective, the
  ``nth`` call of a ``kind``, through the hook in :mod:`..comm.collectives`
  (the verb's values before they cross: under the single controller every
  rank's value, in the multi-process form this process's, which
  ``collectives._transport`` then carries). The reference corrupts when a
  program is traced and clears its program caches on entry and exit; the
  port runs eagerly, so ``nth`` counts calls of the verb, and the port
  holds no cache that keeps a route decision or a payload: none is
  cleared.
* :func:`disable_route` (and :func:`disable_pallas` / :func:`disable_ozaki`):
  a route gate reports "unavailable", driving the kernel -> composed-route
  degradations (``panel``, ``step``, ``pallas_update``, ``ozaki_pallas``;
  ``ozaki_gemm``) without touching the gates' inputs.
* :func:`force_native_failure`: ``native.bindings`` fails its build or
  load (the cached-error re-raise path and every native -> numpy chain).
  It never touches the CUDA kernels: their build or launch failure raises.
* :func:`fail_dispatch`: raises inside the serve dispatch attempt on the
  ``nth`` (and the next ``count - 1``, or every ``every``-th) attempt, the
  transient or flapping fault of the retry and breaker drills.
* :func:`hang`: a clock-aware stall at a policy site: the policy engine
  charges the armed seconds against the attempt's deadline without
  sleeping.
* :func:`preempt`: kills the eigensolver with
  :class:`.errors.PreemptionError` at a stage boundary, after that stage's
  checkpoint landed (kill -> resume -> the same result).

All state is process-global and off by default; a hook's cost when
disarmed is one module-attribute read. Every context disarms on exit, and
those that can trip circuit breakers (:func:`force_native_failure`,
:func:`disable_route`, :func:`fail_dispatch`, :func:`fail_fleet_dispatch`)
reset the breakers they may
have opened, so a drill never fails fast into unrelated code.

* :func:`fail_fleet_dispatch`: the fleet router's twin of
  :func:`fail_dispatch`, counted by FLEET attempt index (a schedule of its
  own, so the router's faults replay exactly while in-process workers
  dispatch).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch

_LOCK = threading.Lock()

#: Armed collective corruption: {"kind", "nth", "seed", "count"} or None.
_COLLECTIVE: Optional[dict] = None

#: Route names currently forced unavailable (see :func:`disable_route`).
_DISABLED_ROUTES: set = set()

#: Armed dispatch faults by schedule: "serve" (the serve dispatch) and
#: "fleet" (the fleet router's ticket dispatch, counted on its own); each
#: {"nth", "count", "every", "exc", "seen"}, absent when disarmed.
_FAIL: dict = {}

#: Armed clock-aware stalls: policy site -> seconds.
_HANGS: dict = {}

#: Armed preemption: the stage name to kill at, or None.
_PREEMPT: Optional[str] = None


# ---------------------------------------------------------------------------
# Data corruption
# ---------------------------------------------------------------------------

def nan_tile(mat, tile: Optional[tuple] = None, element: Optional[tuple] = None,
             seed: int = 0):
    """A copy of ``mat`` with one element of one tile set to NaN.

    ``tile``: global tile index (i, j); ``element``: (row, col) within the
    tile. Either may be None: a deterministic choice is drawn from ``seed``
    over the valid range (the reference's draws, in its order), so repeated
    runs inject the same fault. On a multi-process grid only the process
    that holds the tile writes it."""
    from ..matrix import util_distribution as ud

    dist = mat.dist
    nt_r, nt_c = dist.nr_tiles.row, dist.nr_tiles.col
    if nt_r == 0 or nt_c == 0:
        raise ValueError("nan_tile: matrix has no tiles")
    rng = np.random.default_rng(seed)
    ti, tj = tile if tile is not None else (int(rng.integers(nt_r)), int(rng.integers(nt_c)))
    mb_r = min(dist.block_size.row, dist.size.row - ti * dist.block_size.row)
    mb_c = min(dist.block_size.col, dist.size.col - tj * dist.block_size.col)
    ei, ej = element if element is not None else (int(rng.integers(mb_r)),
                                                  int(rng.integers(mb_c)))
    out = mat.clone()
    if not out.distributed:
        out.storage[ti, tj, ei, ej] = float("nan")
        return out
    P, Q = dist.grid_size.row, dist.grid_size.col
    pr = ud.rank_global_tile(ti, P, dist.source_rank.row)
    pc = ud.rank_global_tile(tj, Q, dist.source_rank.col)
    shard = out.storage[pr * Q + pc]
    if shard is not None:
        shard[ud.local_tile_from_global_tile(ti, P),
              ud.local_tile_from_global_tile(tj, Q), ei, ej] = float("nan")
    return out


def _corrupt_payload(x: torch.Tensor, seed: int) -> torch.Tensor:
    """A copy of ``x`` (in its layout) with one NaN (the dtype's max for an
    integer payload) at a seeded position of its row-major elements; an
    empty placeholder passes through."""
    if x.numel() == 0:
        return x
    y = torch.empty_like(x).copy_(x)
    pos = int(np.random.default_rng(seed).integers(x.numel()))
    y[tuple(int(i) for i in np.unravel_index(pos, tuple(x.shape)))] = (
        float("nan") if (y.is_floating_point() or y.is_complex())
        else torch.iinfo(y.dtype).max)
    return y


def _kind_matches(armed: str, kind: str) -> bool:
    """An armed ``"bcast"`` also matches the one-step 2D diagonal broadcast
    (``"bcast2d"``): the drill targets "a broadcast on the step's critical
    path", wherever the fusion put it."""
    return armed == kind or (armed == "bcast" and kind == "bcast2d")


def _collective_hook(kind: str, axis: str, xs):
    """Installed into ``comm.collectives`` while :func:`corrupt_collective`
    is armed; poisons the values of the nth matching verb call."""
    with _LOCK:
        spec = _COLLECTIVE
        if spec is None or not _kind_matches(spec["kind"], kind):
            return xs
        hit = spec["count"] == spec["nth"]
        spec["count"] += 1
    if not hit:
        return xs
    return [[None if x is None else _corrupt_payload(x, spec["seed"]) for x in row]
            for row in xs]


@contextlib.contextmanager
def corrupt_collective(kind: str = "bcast", nth: int = 0, seed: int = 0):
    """Poison the payload of the ``nth`` ``kind`` verb call (``"bcast"``,
    which also matches ``"bcast2d"``, ``"bcast2d"``, ``"all_reduce"``,
    ``"all_gather"`` or ``"all_to_all"``) while the context is active."""
    global _COLLECTIVE
    from ..comm import collectives as cc

    with _LOCK:
        if _COLLECTIVE is not None:
            raise RuntimeError("corrupt_collective is not reentrant")
        _COLLECTIVE = {"kind": kind, "nth": int(nth), "seed": int(seed), "count": 0}
    cc._INJECT_HOOK = _collective_hook
    try:
        yield
    finally:
        cc._INJECT_HOOK = None
        with _LOCK:
            _COLLECTIVE = None


# ---------------------------------------------------------------------------
# Route availability
# ---------------------------------------------------------------------------

def route_disabled(name: str) -> bool:
    """Has injection forced route ``name`` unavailable? Consulted by the
    route gates (``pallas``: the panel, step, update and pair kernels;
    ``ozaki``: the Ozaki product route)."""
    return name in _DISABLED_ROUTES


@contextlib.contextmanager
def disable_route(name: str):
    """Force route ``name`` unavailable while active; the owning gate
    reports the degradation through :mod:`.registry`. The degradation
    sites' circuit breakers are reset on exit."""
    with _LOCK:
        _DISABLED_ROUTES.add(name)
    try:
        yield
    finally:
        with _LOCK:
            _DISABLED_ROUTES.discard(name)
        _reset_breakers("fallback.")


def disable_pallas():
    """Force every hand-written kernel route that stands for a Pallas one
    off (#1–#5 and #7 of the kernel table; the composed routes run)."""
    return disable_route("pallas")


def disable_ozaki():
    """Force the Ozaki int8 product route off (the native float64 product
    runs)."""
    return disable_route("ozaki")


# ---------------------------------------------------------------------------
# Native library failure
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def force_native_failure():
    """Make ``native.bindings`` fail its build or load while active. The
    libraries' caches are reset on entry and exit so neither a loaded
    library nor the injected failure crosses the boundary; the
    degradation sites' breakers reset both ways for the same reason."""
    from ..native import bindings

    _reset_breakers("fallback.")
    bindings._reset_for_tests(force_failure=True)
    try:
        yield
    finally:
        bindings._reset_for_tests(force_failure=False)
        _reset_breakers("fallback.")


def _reset_breakers(prefix: str) -> None:
    from . import circuit

    circuit.reset(prefix)


# ---------------------------------------------------------------------------
# Dispatch and policy-engine faults
# ---------------------------------------------------------------------------

def _attempt_faulted(slot: str, what: str) -> None:
    """One attempt of schedule ``slot``: raises its armed exception when
    this attempt falls on a faulted index."""
    if slot not in _FAIL:
        return
    with _LOCK:
        spec = _FAIL.get(slot)
        if spec is None:
            return
        idx = spec["seen"]
        spec["seen"] += 1
        if spec["every"] is not None:
            hit = idx >= spec["nth"] and (idx - spec["nth"]) % spec["every"] == 0
        else:
            hit = spec["nth"] <= idx < spec["nth"] + spec["count"]
    if hit:
        raise spec["exc"](f"injected {what} fault (attempt {idx})")


@contextlib.contextmanager
def _arm_attempts(slot: str, name: str, breakers: str, nth: int, count: int,
                  every: Optional[int], exc: type):
    """Arm schedule ``slot`` (the context ``name``) for its extent; the
    breakers whose site starts with ``breakers`` are reset on exit."""
    if count < 1:
        raise ValueError(f"{name}: count={count} must be >= 1")
    if every is not None and every < 1:
        raise ValueError(f"{name}: every={every} must be >= 1")
    with _LOCK:
        if slot in _FAIL:
            raise RuntimeError(f"{name} is not reentrant")
        _FAIL[slot] = {"nth": int(nth), "count": int(count),
                       "every": None if every is None else int(every),
                       "exc": exc, "seen": 0}
    try:
        yield
    finally:
        with _LOCK:
            _FAIL.pop(slot, None)
        _reset_breakers(breakers)


def maybe_fail_dispatch() -> None:
    """Hook of the serve dispatch path, once per dispatch ATTEMPT (so the
    policy's retries meet the fault again): raises the armed exception
    when this attempt falls on a faulted index."""
    _attempt_faulted("serve", "dispatch")


def fail_dispatch(nth: int = 0, count: int = 1, every: Optional[int] = None,
                  exc: type = RuntimeError):
    """Raise ``exc`` inside the serve dispatch attempt, by attempt index:
    attempts ``nth .. nth+count-1`` fail (or, with ``every``, every
    ``every``-th attempt from ``nth`` on: the flapping fault of the breaker
    soak). Not reentrant; the ``serve.`` breakers are reset on exit."""
    return _arm_attempts("serve", "fail_dispatch", "serve.", nth, count, every, exc)


def maybe_fail_fleet_dispatch() -> None:
    """Hook the fleet router consults once per ticket-dispatch attempt
    (inside the retried attempt, so the fault meets the policy's retries
    and the routed worker's breaker): raises the armed exception when this
    attempt falls on a faulted index."""
    _attempt_faulted("fleet", "fleet dispatch")


def fail_fleet_dispatch(nth: int = 0, count: int = 1, every: Optional[int] = None,
                        exc: type = RuntimeError):
    """Raise ``exc`` inside the fleet router's ticket-dispatch attempt, by
    fleet attempt index, as :func:`fail_dispatch` does for the serve
    dispatch. Not reentrant; the ``fleet.`` breakers are reset on exit, so
    an injected storm never leaves a worker's breaker failing fast into
    real routing."""
    return _arm_attempts("fleet", "fail_fleet_dispatch", "fleet.", nth, count, every, exc)


def hang_seconds(site: str) -> float:
    """The armed stall of ``site`` (0.0 when unarmed): the policy engine
    adds it to each attempt's measured time (see :func:`hang`)."""
    if not _HANGS:
        return 0.0
    with _LOCK:
        return _HANGS.get(site, 0.0)


@contextlib.contextmanager
def hang(site: str, seconds: float):
    """Arm a clock-aware stall at policy site ``site``: while active, every
    attempt :func:`.policy.with_policy` runs there is charged ``seconds``
    more against ``RetryPolicy.attempt_deadline_s``, without sleeping."""
    if not seconds >= 0:
        raise ValueError(f"hang: seconds={seconds} must be >= 0")
    with _LOCK:
        if site in _HANGS:
            raise RuntimeError(f"hang({site!r}) is not reentrant")
        _HANGS[site] = float(seconds)
    try:
        yield
    finally:
        with _LOCK:
            _HANGS.pop(site, None)


# ---------------------------------------------------------------------------
# Preemption (kill-and-resume drills)
# ---------------------------------------------------------------------------

def maybe_preempt(stage: str) -> None:
    """Hook of the pipeline at each stage BOUNDARY (after the stage's
    checkpoint landed): raises PreemptionError when ``stage`` is armed."""
    armed = _PREEMPT
    if armed is not None and armed == stage:
        from .. import obs
        from .errors import PreemptionError

        obs.emit_event("resilience", site="pipeline", event="preempt",
                       attrs={"stage": stage})
        raise PreemptionError(stage)


@contextlib.contextmanager
def preempt(stage: str):
    """Kill the eigensolver with :class:`.errors.PreemptionError` at stage
    boundary ``stage`` (red2band | b2t | tridiag | bt_b2t | bt_r2b), AFTER
    that stage's ``DLAF_RESUME_DIR`` checkpoint was written. Not
    reentrant; disarms on exit."""
    global _PREEMPT
    with _LOCK:
        if _PREEMPT is not None:
            raise RuntimeError("preempt is not reentrant")
        _PREEMPT = str(stage)
    try:
        yield
    finally:
        with _LOCK:
            _PREEMPT = None
