"""Leveled, component-scoped logging.

Analog of av_log (libavutil/log.h:192-238): numeric levels
matching the reference's constants, a global level, per-component override,
and a pluggable callback — thin enough to stay out of the hot path.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable

QUIET = -8
PANIC = 0
FATAL = 8
ERROR = 16
WARNING = 24
INFO = 32
VERBOSE = 40
DEBUG = 48
TRACE = 56

_NAMES = {
    PANIC: "panic", FATAL: "fatal", ERROR: "error", WARNING: "warning",
    INFO: "info", VERBOSE: "verbose", DEBUG: "debug", TRACE: "trace",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}
_BY_NAME["quiet"] = QUIET

_level = int(os.environ.get("LIBREMPEG_TPU_LOG_LEVEL", INFO))
_component_levels: dict[str, int] = {}
_callback: Callable[[str, int, str], None] | None = None


def set_level(level: int | str) -> None:
    global _level
    _level = _BY_NAME[level] if isinstance(level, str) else int(level)


def get_level() -> int:
    return _level


def set_component_level(component: str, level: int | str) -> None:
    _component_levels[component] = (
        _BY_NAME[level] if isinstance(level, str) else int(level)
    )


def set_callback(cb: Callable[[str, int, str], None] | None) -> None:
    """cb(component, level, message); None restores default stderr writer."""
    global _callback
    _callback = cb


def log(component: str, level: int, msg: str, *args) -> None:
    limit = _component_levels.get(component, _level)
    if level > limit:
        return
    if args:
        msg = msg % args
    if _callback is not None:
        _callback(component, level, msg)
        return
    name = _NAMES.get(level, str(level))
    print(f"[{component} @ {name}] {msg}", file=sys.stderr)


class Logger:
    """Per-component convenience wrapper: ``log = Logger("scaler")``."""

    def __init__(self, component: str):
        self.component = component

    def error(self, msg: str, *a) -> None:
        log(self.component, ERROR, msg, *a)

    def warning(self, msg: str, *a) -> None:
        log(self.component, WARNING, msg, *a)

    def info(self, msg: str, *a) -> None:
        log(self.component, INFO, msg, *a)

    def verbose(self, msg: str, *a) -> None:
        log(self.component, VERBOSE, msg, *a)

    def debug(self, msg: str, *a) -> None:
        log(self.component, DEBUG, msg, *a)
