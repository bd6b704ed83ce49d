"""The closed-loop controller: probe -> table -> route.

Port of ``dlaf_tpu/autotune/controller.py``. An algorithm entry asks
:func:`steering_for_matrix` for its site's route before it runs, holds
:meth:`Steering.applied` around its whole eager call and, when its input
survived (not donated) and the probe cadence is due, feeds the result's
Hutchinson probe (:mod:`..obs.accuracy`, no new device code) back through
:meth:`Steering.observe`. The ``bound_ratio`` normalization is
:func:`..obs.accuracy.emit`'s, computed with ``record=False``: the probe
lands in the ``autotune`` decision record, while ``accuracy`` records stay
the ``DLAF_ACCURACY`` knob's business.

Every decision (holds included) lands as one ``autotune`` record (site,
op, rungs, old and new route, probe, reason; :mod:`..obs.sinks` owns the
schema) with the ``dlaf_autotune_route{op,knob}`` gauges and the
``dlaf_autotune_decisions_total{op,reason}`` /
``dlaf_autotune_escalations_total{op}`` counters. Exhaustion (a breach at
the ladder's top) also counts ``dlaf_autotune_exhausted_total{op}``,
trips the flight recorder (``autotune_exhausted``) and, under
``DLAF_STRICT``, raises :class:`..health.errors.AutotuneExhaustedError`.

``platform`` is the device type of the call (``cuda``, ``cpu``), as the
port's ``accuracy`` records spell it. In the multi-process form every
process keeps its own table; the probe estimators all-reduce over both
grid axes, so every process feeds :func:`..table.decide` the same ratio
and takes the same decision. Only process 0 writes ``DLAF_AUTOTUNE_TABLE``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

from . import routes as _routes
from .routes import Ladder, Route, applied, ladder_for
from .table import Decision, RouteTable, SiteKey, site_key

__all__ = ["enabled", "steering", "steering_for_matrix", "Steering",
           "observe_ratio", "ingest_result", "applied", "get_table",
           "route_metric_values"]


def _default_platform() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def enabled(platform: Optional[str] = None) -> bool:
    """The layered ``DLAF_AUTOTUNE`` knob, "auto" resolved per device type
    (:func:`..config.resolve_autotune`: "0" on ``cuda`` and ``cpu``)."""
    from ..config import resolve_autotune

    return resolve_autotune(platform or _default_platform()) == "1"


# ---------------------------------------------------------------------------
# Process table
# ---------------------------------------------------------------------------

_TABLE: Optional[RouteTable] = None
_TABLE_PATH: Optional[str] = None
_TABLE_LOCK = threading.Lock()


def get_table() -> RouteTable:
    """The process route table, re-bound (and warm-started) whenever the
    ``DLAF_AUTOTUNE_TABLE`` knob changes. A configured path that exists
    loads at once, and a malformed, stale or other-version table raises
    here, naming the field. Only process 0 (no process group, or rank 0)
    writes the path back."""
    global _TABLE, _TABLE_PATH
    from ..config import get_configuration
    from ..obs._state import current_rank

    path = str(get_configuration().autotune_table or "")
    with _TABLE_LOCK:
        if _TABLE is None or path != _TABLE_PATH:
            tab = RouteTable(path, writer=current_rank() in (None, 0))
            if path and os.path.exists(path):
                tab.load(path)
            _TABLE = tab
            _TABLE_PATH = path
        return _TABLE


def _reset_for_tests() -> None:
    global _TABLE, _TABLE_PATH
    with _TABLE_LOCK:
        _TABLE = None
        _TABLE_PATH = None


# ---------------------------------------------------------------------------
# Steering handle
# ---------------------------------------------------------------------------

#: Gauge encodings of the non-numeric route knobs
#: (``dlaf_autotune_route{op,knob}``): higher = more conservative.
_KNOB_VALUES = {
    "f64_trsm": {"mixed": 0.0, "native": 1.0},
    "panel_impl": {"fused": 0.0, "xla": 1.0},
    "ozaki_impl": {"pallas": 0.0, "jnp": 1.0},
    "step_impl": {"fused": 0.0, "xla": 1.0},
}


def route_metric_values(route: Route) -> dict:
    """knob -> gauge value of a route's overrides (inherited fields
    report nothing)."""
    out = {}
    for knob, value in route.as_dict().items():
        if knob == "f64_gemm_slices":
            out[knob] = float(value)
        else:
            out[knob] = _KNOB_VALUES[knob][value]
    return out


@dataclasses.dataclass
class Steering:
    """One entry call's steering handle: the key, the ladder and the
    route in effect for the call (:func:`steering`)."""

    key: SiteKey
    ladder: Ladder
    route: Route
    site: str
    #: the call's own order (not the bucket's ceiling): the probe's budget
    #: must be the one the ``accuracy`` records use for the same result
    n: int = 0
    #: the probe cadence's verdict (``DLAF_AUTOTUNE_PROBE_EVERY``): the
    #: entry skips the probe when False (the route still applies)
    probe_due: bool = True

    def applied(self):
        """Context manager applying :attr:`route`."""
        return _routes.applied(self.route)

    def observe(self, value, *, c: float, of=None,
                attrs: Optional[dict] = None) -> Decision:
        """Feed one raw probe estimate (the residual) into the table,
        normalized by :func:`..obs.accuracy.emit` with ``record=False``;
        returns the decision (its record and metrics emitted, strict
        raising on exhaustion)."""
        from ..obs import accuracy

        res = accuracy.emit(self.site, "autotune_probe", value,
                            n=self.n or self.key.n_bucket, nb=self.key.nb,
                            dtype=self.key.dtype, c=c, of=of, record=False)
        ratio = res.bound_ratio if res.finite and res.bound_ratio is not None \
            else float("inf")
        return observe_ratio(self.key, self.ladder, ratio,
                             probe_value=res.value if res.finite else None,
                             attrs=attrs)


def steering(op: str, *, n: int, nb: int, dtype, platform: Optional[str] = None,
             tick: bool = False) -> Optional[Steering]:
    """The steering handle of one call, or None when the loop is closed
    for it: knob off, an untuned dtype (no ladder), or an empty problem.
    ``platform`` is the call's device type (default: ``cuda`` when a card
    is visible). ``tick=True`` counts the call against the site's probe
    cadence and sets :attr:`Steering.probe_due`: the algorithm entries
    tick, the serve queue's spec lookups do not."""
    platform = platform or _default_platform()
    if int(n) < 1 or not enabled(platform):
        return None
    ladder = ladder_for(dtype)
    if ladder is None:
        return None
    key = site_key(op, n=n, nb=nb, dtype=dtype, platform=platform)
    table = get_table()
    route = table.route_for(key, ladder)
    due = True
    if tick:
        from ..config import get_configuration

        due = table.tick(key, ladder, get_configuration().autotune_probe_every)
    return Steering(key=key, ladder=ladder, route=route, site=key.label, n=int(n),
                    probe_due=due)


def steering_for_matrix(op: str, mat) -> Optional[Steering]:
    """:func:`steering` of an entry's :class:`..matrix.matrix.Matrix`
    argument, on its device type, ticking the probe cadence."""
    if mat.size.row == 0 or mat.size.col == 0:
        return None
    return steering(op, n=mat.size.row, nb=mat.block_size.row, dtype=mat.dtype,
                    platform=mat.device.type, tick=True)


def ingest_result(op: str, result, *, n: int, nb: int, dtype,
                  platform: Optional[str] = None,
                  attrs: Optional[dict] = None) -> Optional[Decision]:
    """Feed an already computed :class:`..obs.accuracy.AccuracyResult`
    into the table: the donated-entry path (a timed miniapp run donates
    its input, so the entry has nothing to probe, while the miniapp's
    check computes the same residual against its kept copy). An
    informational result (no budget), an untuned dtype or a closed loop
    is ignored. Returns the decision, or None."""
    platform = platform or _default_platform()
    if not enabled(platform):
        return None
    ladder = ladder_for(dtype)
    if ladder is None or result.tol is None:
        return None
    key = site_key(op, n=n, nb=nb, dtype=dtype, platform=platform)
    ratio = result.bound_ratio if result.finite and result.bound_ratio is not None \
        else float("inf")
    return observe_ratio(key, ladder, ratio,
                         probe_value=result.value if result.finite else None,
                         attrs=dict(attrs or {}, source="ingest"))


def observe_ratio(key: SiteKey, ladder: Ladder, ratio: float, *,
                  probe_value: Optional[float] = None,
                  attrs: Optional[dict] = None) -> Decision:
    """Feed one normalized ``bound_ratio`` for ``key`` into the table and
    publish the decision (record, gauges, counters, flight and strict
    handling). The serve queue calls this with its per-dispatch worst
    lane; entries go through :meth:`Steering.observe`."""
    from .. import obs
    from ..config import get_configuration

    cfg = get_configuration()
    decision = get_table().observe(
        key, ladder, ratio, margin=float(cfg.autotune_margin),
        relax_after=int(cfg.autotune_relax_after), budget=int(cfg.autotune_budget))
    # both routes from THE decision's rungs: a second table read could pair
    # one decision's old rung with another's route under concurrent feeds
    route_old = ladder.rungs[decision.rung_old]
    route_new = ladder.rungs[decision.rung_new]
    rec = {"site": key.label, "op": key.op, "n_bucket": key.n_bucket,
           "nb": key.nb, "dtype": key.dtype, "platform": key.platform,
           "reason": decision.reason, "rung_old": decision.rung_old,
           "rung_new": decision.rung_new,
           "route_old": route_old.as_dict(), "route_new": route_new.as_dict(),
           "probe": None if decision.nonfinite else float(decision.probe),
           "attrs": dict(attrs or {})}
    if decision.nonfinite:
        rec["nonfinite"] = True
    if probe_value is not None:
        rec["attrs"].setdefault("value", float(probe_value))
    obs.emit_event("autotune", **rec)
    if obs.metrics_active():
        obs.gauge("dlaf_autotune_route", op=key.op, knob="rung").set(float(decision.rung_new))
        for knob, val in route_metric_values(route_new).items():
            obs.gauge("dlaf_autotune_route", op=key.op, knob=knob).set(val)
        obs.counter("dlaf_autotune_decisions_total", op=key.op, reason=decision.reason).inc()
        if decision.reason == "escalate":
            obs.counter("dlaf_autotune_escalations_total", op=key.op).inc()
    if decision.reason == "exhausted":
        from ..health.registry import strict_mode
        from ..obs import flight

        if obs.metrics_active():
            obs.counter("dlaf_autotune_exhausted_total", op=key.op).inc()
        # the open incident: dump the ring (the exhausted record is in it)
        flight.trigger("autotune_exhausted", site=key.label, rung=decision.rung_new,
                       ladder=ladder.name,
                       bound_ratio=None if decision.nonfinite else float(decision.probe))
        obs.get_logger("autotune").warning_once(
            ("autotune_exhausted", key.label),
            f"autotune ladder exhausted at {key.label}: probe bound_ratio "
            f"{decision.probe!r} breached the budget at the TOP rung "
            f"({decision.rung_new}) of the {ladder.name} ladder; no safer route "
            "exists (DLAF_STRICT=1 raises)")
        if strict_mode():
            from ..health.errors import AutotuneExhaustedError

            raise AutotuneExhaustedError(
                key.label, rung=decision.rung_new, ladder=ladder.name,
                bound_ratio=float("inf") if decision.nonfinite else float(decision.probe))
    return decision
