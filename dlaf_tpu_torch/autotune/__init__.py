"""dlaf_tpu_torch.autotune: accuracy-steered route selection.

Port of ``dlaf_tpu/autotune/`` (its ``__all__``, ``__init__.py:40-51``).
The route knobs (``f64_gemm_slices``, ``f64_trsm``, ``panel_impl``,
``ozaki_impl``, ``step_impl``) become a policy chosen per ``(op,
n-bucket, nb, dtype, device type)`` from the measured ``bound_ratio`` of
the accuracy probes (:mod:`..obs.accuracy`), behind the ``DLAF_AUTOTUNE``
knob ("0"/"1"/"auto"; auto is "0" on ``cuda`` and ``cpu``):

* :mod:`.routes`: :class:`Route`, the ladders and the active-route context
  that ``config.resolve`` and ``config.resolve_slices`` consult;
* :mod:`.table`: :class:`RouteTable`, the pure :func:`decide` and the
  atomic JSON persistence (``DLAF_AUTOTUNE_TABLE``);
* :mod:`.controller`: the per-entry :func:`steering` handle (route out,
  probe in), the ``autotune`` records and metrics, exhaustion (flight
  recorder, ``DLAF_STRICT``).

Steered: ``cholesky`` (op ``cholesky``), ``triangular_solve`` (``trsm``),
``gen_to_std`` (``hegst``), ``eigensolver`` (``eigensolver``: the route
around reduction to band and its back-transform only), the Cholesky
miniapp's checks (:func:`ingest_result`) and the serve queue's buckets.

Cost contract: with the knob off an entry pays one configuration read and
no probe, and its output is bitwise what it was without the autotuner; on,
at a start rung that is the configured default, it is bitwise the same
too (``tests/test_torch_autotune.py``).
"""

from __future__ import annotations

from .controller import (Steering, applied, enabled, get_table, ingest_result, observe_ratio,
                         route_metric_values, steering, steering_for_matrix)
from .routes import LADDER_F32, LADDER_F64, Ladder, Route, active, ladder_for, override
from .table import (HISTORY_CAP, REASONS, TABLE_VERSION, Decision, Entry, RouteTable, SiteKey,
                    bucket_n, decide, site_key)

__all__ = [
    "Route", "Ladder", "LADDER_F64", "LADDER_F32", "ladder_for",
    "active", "override", "applied",
    "RouteTable", "SiteKey", "Entry", "Decision", "decide", "site_key",
    "bucket_n", "REASONS", "TABLE_VERSION", "HISTORY_CAP",
    "enabled", "steering", "steering_for_matrix", "Steering",
    "observe_ratio", "ingest_result", "get_table", "route_metric_values",
]


def _reset_for_tests() -> None:
    from . import controller

    controller._reset_for_tests()
