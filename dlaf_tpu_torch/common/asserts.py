"""Assertions.

Counterpart of ``dlaf_tpu/common/asserts.py`` (reference
``common/assert.h:105-121``): three severity tiers, each switched on its
own and read at import time, that raise with the failing message and a
source location:

* ``dlaf_assert``, ``DLAF_ASSERT_ENABLE`` (default: on);
* ``dlaf_assert_moderate``, ``DLAF_ASSERT_MODERATE_ENABLE`` (default: on;
  the reference's C++ default: debug builds only);
* ``dlaf_assert_heavy``, ``DLAF_ASSERT_HEAVY_ENABLE`` (default: off).
"""

from __future__ import annotations

import inspect
import os


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "off", "false", "no", "")


ASSERT_ENABLED = _env_flag("DLAF_ASSERT_ENABLE", True)
ASSERT_MODERATE_ENABLED = _env_flag("DLAF_ASSERT_MODERATE_ENABLE", True)
ASSERT_HEAVY_ENABLED = _env_flag("DLAF_ASSERT_HEAVY_ENABLE", False)


class DlafAssertError(AssertionError):
    """Raised on a failed DLAF assertion (the reference aborts)."""


def _fail(level: str, message: str, extras: tuple) -> None:
    frame = inspect.stack()[2]
    loc = f"{frame.filename}:{frame.lineno} in {frame.function}"
    extra = ("\n  " + "\n  ".join(str(e) for e in extras)) if extras else ""
    raise DlafAssertError(f"[{level}] {message}\n  at {loc}{extra}")


def dlaf_assert(cond: bool, message: str = "", *extras) -> None:
    """Tier-1 assertion: cheap invariants, on by default."""
    if ASSERT_ENABLED and not cond:
        _fail("DLAF_ASSERT", message, extras)


def dlaf_assert_moderate(cond: bool, message: str = "", *extras) -> None:
    """Tier-2 assertion: checks of moderate cost, on by default."""
    if ASSERT_MODERATE_ENABLED and not cond:
        _fail("DLAF_ASSERT_MODERATE", message, extras)


def dlaf_assert_heavy(cond: bool, message: str = "", *extras) -> None:
    """Tier-3 assertion: expensive checks, off by default."""
    if ASSERT_HEAVY_ENABLED and not cond:
        _fail("DLAF_ASSERT_HEAVY", message, extras)
