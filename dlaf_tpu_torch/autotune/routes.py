"""Precision routes and their escalation ladders.

Port of ``dlaf_tpu/autotune/routes.py``. A :class:`Route` is one point in
the precision/speed trade the autotuner steers: overrides over the
resolved config knobs (``f64_gemm_slices``, ``f64_trsm``, ``panel_impl``,
``ozaki_impl``, ``step_impl``). A field left ``None`` inherits the
ordinary resolution, so the EMPTY route is the configured default.

A *ladder* is an ordered tuple of routes from the fastest, least
conservative (rung 0) to the safest (top rung), with a ``start`` rung. The
rung lists and :attr:`Ladder.ident` strings are the reference's letter
for letter, so the two packages' persisted tables load in each other.

Where each rung binds in the port (``config.resolve`` and
``config.resolve_slices`` consult :func:`override`; the panel kernels'
gate keeps a route's ``fused`` inert off the card):

* f32/bf16 (:data:`LADDER_F32`): rung 0's ``step_impl="fused"`` binds on
  ``cuda`` only (where ``auto`` already resolves it: rung 0 is rung 1
  there); rung 2's ``step_impl="xla"`` closes the step kernel (#4) on
  ``cuda``; rung 3 also closes the panel kernels (#1-#3). On ``cpu`` the
  auto routes are already "xla": every rung is inert.
* f64/complex128 (:data:`LADDER_F64`): the slice counts and
  ``ozaki_impl`` bind only where ``f64_gemm`` resolves "mxu" (the Ozaki
  kernels #6-#8); ``f64_trsm="native"`` is already the default on both
  devices; rung 0's ``step_impl="fused"`` never binds (the step kernel is
  f32/bf16 only, and a route override never counts a fallback). Under
  the default ``f64_gemm="native"`` the whole ladder is inert. Its start
  rung is s=7, the reference's TPU default: under an explicit
  ``f64_gemm=mxu``, whose own auto is 8 slices here, the autotuner starts
  one slice below the knob's choice.

The ACTIVE route is a contextvar (:func:`applied`). Eager PyTorch reads
the routed knobs as it runs, not at a trace, so an entry holds the route
around its whole call; a thread does not inherit it (the serve queue's
bucket programs apply their own route, :mod:`..serve.programs`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import numpy as np

#: Fields a route may override, in serialization order. Each is the name
#: of the config knob it shadows.
ROUTE_FIELDS = ("f64_gemm_slices", "f64_trsm", "panel_impl", "ozaki_impl",
                "step_impl")


@dataclasses.dataclass(frozen=True)
class Route:
    """One precision route: overrides over the resolved config knobs
    (None = inherit the ordinary resolution)."""

    f64_gemm_slices: Optional[int] = None
    f64_trsm: Optional[str] = None        # "mixed" | "native"
    panel_impl: Optional[str] = None      # "fused" | "xla"
    ozaki_impl: Optional[str] = None      # "jnp" | "pallas"
    step_impl: Optional[str] = None       # "fused" | "xla"

    def key(self) -> tuple:
        """Hashable key component: a route change is a new program key
        (:mod:`..obs.telemetry`, the serve specs). The empty route keys as
        ``()``, so route-free callers keep their identities."""
        items = tuple((f, getattr(self, f)) for f in ROUTE_FIELDS
                      if getattr(self, f) is not None)
        return items

    def tag(self) -> str:
        """Compact human/metric label, e.g. ``s5.ozpallas`` (``default``
        for the empty route) — bounded cardinality: one per ladder rung."""
        parts = []
        if self.f64_gemm_slices is not None:
            parts.append(f"s{self.f64_gemm_slices}")
        if self.f64_trsm is not None:
            parts.append(f"trsm_{self.f64_trsm}")
        if self.panel_impl is not None:
            parts.append(f"panel_{self.panel_impl}")
        if self.ozaki_impl is not None:
            parts.append(f"oz{self.ozaki_impl}")
        if self.step_impl is not None:
            parts.append(f"step_{self.step_impl}")
        return ".".join(parts) or "default"

    def as_dict(self) -> dict:
        """The non-None overrides (JSONL ``autotune`` record payload)."""
        return {f: getattr(self, f) for f in ROUTE_FIELDS
                if getattr(self, f) is not None}


@dataclasses.dataclass(frozen=True)
class Ladder:
    """An escalation ladder: rungs fast -> safe, plus the start rung
    (the platform-default route) and a stable identity string that the
    persisted table refuses to warm-start across (a rung learned against
    one ladder must not index into a different one)."""

    name: str
    rungs: Tuple[Route, ...]
    start: int

    def __post_init__(self):
        assert 0 <= self.start < len(self.rungs), \
            f"ladder {self.name}: start {self.start} outside rungs"

    @property
    def ident(self) -> str:
        """Version-stable identity: name + rung count + every rung tag.
        Any ladder edit changes it, which makes previously persisted
        entries for it STALE (table.load refuses loudly)."""
        return f"{self.name}:{len(self.rungs)}:" + \
            ",".join(r.tag() for r in self.rungs)


#: f64/complex128 ladder: the Ozaki slice count s=5..8, with the slice
#: kernels' double-f32 fold (``ozaki_impl="pallas"``) as the bottom rung
#: and native-f64 panel solves (``f64_trsm="native"``) as the safety top;
#: rung 3 (s=7) is the start. Rung 0's ``step_impl="fused"`` is dormant
#: (module docstring). The reference's rungs, letter for letter.
LADDER_F64 = Ladder(
    name="f64",
    rungs=(
        Route(f64_gemm_slices=5, ozaki_impl="pallas", step_impl="fused"),
        Route(f64_gemm_slices=5),
        Route(f64_gemm_slices=6),
        Route(f64_gemm_slices=7),
        Route(f64_gemm_slices=8),
        Route(f64_gemm_slices=8, f64_trsm="native"),
    ),
    start=3,
)

#: f32/bf16 ladder: the fused step kernel (rung 0) above the configured
#: default (start), then the panel kernels alone (``step_impl="xla"``),
#: then the composed route (``panel_impl="xla"`` too). The reference's
#: rungs, letter for letter.
LADDER_F32 = Ladder(
    name="f32",
    rungs=(
        Route(step_impl="fused"),
        Route(),
        Route(step_impl="xla"),
        Route(step_impl="xla", panel_impl="xla"),
    ),
    start=1,
)

_LADDERS = {"float64": LADDER_F64, "complex128": LADDER_F64,
            "float32": LADDER_F32, "bfloat16": LADDER_F32}


def dtype_name(dtype) -> str:
    """``dtype``'s numpy name (``"float64"``, ``"bfloat16"``, ...) from a
    torch dtype, a numpy dtype or a name; "" when it names none."""
    s = str(dtype)
    if s.startswith("torch."):
        return s[len("torch."):]
    if s == "bfloat16":
        return s
    try:
        return np.dtype(dtype).name
    except TypeError:
        return ""


def ladder_for(dtype) -> Optional[Ladder]:
    """The ladder tuning this dtype's routes, or None (dtype untuned: the
    autotuner leaves it alone). Takes torch and numpy dtypes and names."""
    return _LADDERS.get(dtype_name(dtype))


# ---------------------------------------------------------------------------
# Active-route context
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "dlaf_autotune_route", default=None)


def active() -> Optional[Route]:
    """The route applied by the innermost :func:`applied` context (None =
    no override, ordinary knob resolution)."""
    return _ACTIVE.get()


def override(field: str):
    """The active route's override for ``field`` (None = inherit) — the
    one consult the knob-resolution single owners make."""
    route = _ACTIVE.get()
    return None if route is None else getattr(route, field)


def span_attrs() -> dict:
    """``{"autotune_route": overrides}`` of the active route for an entry
    span's attrs (the reference's), or ``{}`` without one."""
    route = _ACTIVE.get()
    return {"autotune_route": route.as_dict()} if route is not None and route.key() else {}


@contextlib.contextmanager
def applied(route: Optional[Route]):
    """Apply ``route``'s overrides for the duration (None = no-op).
    Entries hold this open around their whole eager call: the routed
    knobs are read as the call runs (module docstring)."""
    if route is None:
        yield
        return
    token = _ACTIVE.set(route)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
