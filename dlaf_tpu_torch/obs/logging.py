"""Leveled structured logger (the ``DLAF_LOG`` knob).

Port of ``dlaf_tpu/obs/logging.py``: one line format on stderr, five
levels (debug/info/warning/error/off, :data:`._state.LOG_LEVELS`), a
one-shot variant for the resolve-once configuration notices, and, when a
JSONL sink is active, a structured ``log`` record per emitted line.

Level resolution is layered like every other knob: built-in default
("info") < ``Configuration.log`` < ``DLAF_LOG`` env <
``--dlaf:log=<level>`` (see :mod:`dlaf_tpu_torch.config`).
"""

from __future__ import annotations

import sys
import threading

from ._state import LOG_LEVELS, STATE, ensure_env_defaults

_loggers: dict = {}
_once_lock = threading.Lock()
_once_seen: set = set()


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def is_enabled(self, level: str) -> bool:
        ensure_env_defaults()
        return LOG_LEVELS[level] >= STATE.log_level_num

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if not self.is_enabled(level):
            return
        suffix = ""
        if fields:
            suffix = " [" + " ".join(f"{k}={v}" for k, v in fields.items()) \
                + "]"
        print(f"dlaf_tpu_torch[{level}] {self.name}: {msg}{suffix}",
              file=sys.stderr, flush=True)
        if STATE.sink is not None:
            STATE.sink.write({"type": "log", "level": level,
                              "logger": self.name, "msg": msg,
                              "fields": fields})

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields) -> None:
        self._emit("error", msg, fields)

    def warning_once(self, key, msg: str, **fields) -> None:
        """One-shot warning keyed on ``(logger, key)`` — the resolve-once
        configuration notices (the auto knobs) announce each distinct
        outcome exactly once per process."""
        if not self.is_enabled("warning"):
            # suppressed: leave the key unconsumed so a later
            # initialize() that raises the level still gets the one
            # announcement — "auto decisions must not be silent"
            return
        k = (self.name, key)
        with _once_lock:
            if k in _once_seen:
                return
            _once_seen.add(k)
        self._emit("warning", msg, fields)


def get_logger(name: str = "dlaf") -> Logger:
    lg = _loggers.get(name)
    if lg is None:
        lg = _loggers[name] = Logger(name)
    return lg


def reset_once() -> None:
    """Forget one-shot keys (tests; config cache invalidation)."""
    with _once_lock:
        _once_seen.clear()


def forget_once(logger_name: str, key) -> None:
    """Forget one ``warning_once`` key so the notice can re-announce
    (tests that capture a specific resolution notice)."""
    with _once_lock:
        _once_seen.discard((logger_name, key))


def once_seen_keys(logger_name: str) -> set:
    """Keys ``logger_name`` has already announced (tests: capture the
    pre-state so order-independent cleanup restores exactly it)."""
    with _once_lock:
        return {k for (ln, k) in _once_seen if ln == logger_name}
