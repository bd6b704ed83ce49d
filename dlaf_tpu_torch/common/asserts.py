"""Assertions.

Counterpart of ``dlaf_tpu/common/asserts.py`` (reference
``common/assert.h``), cut to the tier the port uses: ``dlaf_assert``,
switched by ``DLAF_ASSERT_ENABLE`` (default: on) read at import time.
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

