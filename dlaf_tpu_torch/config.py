"""Runtime configuration: the knobs the local Cholesky path reads.

Counterpart of ``dlaf_tpu/config.py``, cut to four knobs. Same layering
(highest wins): ``--dlaf:<knob>=<value>`` arguments > ``DLAF_<KNOB>``
environment variables > a user ``Configuration`` > the defaults.

"auto" resolves per DEVICE TYPE of the call (the JAX package resolves per
process backend): on ``cuda`` the way the reference resolves on ``tpu``
(fused step, fused panel, lookahead 1, and for the trailing update the
masked whole product "biggemm", which is what the reference's TPU choice
"ozaki" runs for f32/bf16); on ``cpu`` as the reference does there
(trailing "loop", panel/step "xla", lookahead 0). Every auto resolution is
announced once on stderr so the route in effect is never silent.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional, Sequence

#: Trailing-update formulations this port implements.
VALID_TRAILING = ("loop", "biggemm")


@dataclasses.dataclass
class Configuration:
    #: Blocked-Cholesky trailing update: "loop" (per block column herk +
    #: gemm, exact flops), "biggemm" (one masked whole product per step),
    #: or "auto".
    cholesky_trailing: str = "auto"
    #: Look-ahead step order: "1" updates the next panel column first and
    #: carries it to the next step, "0" the plain order; "auto" per device.
    #: The factor is bitwise the same either way.
    cholesky_lookahead: str = "auto"
    #: Diagonal-tile potrf and panel strip solve: "fused" (the hand-written
    #: kernels of ``tile_ops/panel_kernels.py``), "xla" (the composed
    #: torch.linalg route, named after the reference's), or "auto".
    panel_impl: str = "auto"
    #: Whole blocked step (potrf + strip solve + adjacent trailing column)
    #: through the fused step kernels: "fused", "xla" or "auto".
    step_impl: str = "auto"


_VALID_CHOICES = {
    "cholesky_trailing": VALID_TRAILING + ("auto",),
    "cholesky_lookahead": ("0", "1", "auto"),
    "panel_impl": ("fused", "xla", "auto"),
    "step_impl": ("fused", "xla", "auto"),
}

#: auto resolution per device type: (cuda choice, cpu choice).
_AUTO = {
    "cholesky_trailing": ("biggemm", "loop"),
    "cholesky_lookahead": ("1", "0"),
    "panel_impl": ("fused", "xla"),
    "step_impl": ("fused", "xla"),
}


def update_configuration(user: Optional[Configuration] = None,
                         argv: Optional[Sequence[str]] = None) -> Configuration:
    """Resolve the effective configuration from the layers above."""
    cfg = dataclasses.replace(user) if user is not None else Configuration()
    names = [f.name for f in dataclasses.fields(cfg)]
    for name in names:
        env = os.environ.get("DLAF_" + name.upper())
        if env is not None:
            setattr(cfg, name, env.strip())
    for arg in argv or ():
        if not arg.startswith("--dlaf:") or "=" not in arg:
            continue
        key, val = arg[len("--dlaf:"):].split("=", 1)
        key = key.replace("-", "_")
        if key in names:
            setattr(cfg, key, val.strip())
    for name, allowed in _VALID_CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"configuration {name}={getattr(cfg, name)!r}: "
                             f"must be one of {allowed}")
    return cfg


_active: Optional[Configuration] = None
_announced: set = set()


def initialize(user: Optional[Configuration] = None,
               argv: Optional[Sequence[str]] = None) -> Configuration:
    """Resolve and activate the configuration; safe to call again."""
    global _active
    _active = update_configuration(user, argv)
    return _active


def get_configuration() -> Configuration:
    """Active configuration, initializing with defaults on first use."""
    return _active if _active is not None else initialize()


def resolve(knob: str, device_type: str) -> str:
    """``knob``'s value with "auto" resolved for ``device_type`` ("cuda"
    or "cpu"), announced once per (knob, device type, choice)."""
    value = getattr(get_configuration(), knob)
    if value != "auto":
        return value
    choice = _AUTO[knob][0 if device_type == "cuda" else 1]
    key = (knob, device_type, choice)
    if key not in _announced:
        _announced.add(key)
        print(f"[dlaf_tpu_torch] {knob}=auto resolved to {choice!r} for "
              f"device {device_type!r} — set the knob explicitly to override",
              file=sys.stderr)
    return choice
