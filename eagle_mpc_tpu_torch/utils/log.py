"""Leveled, colored logging to standard error (counterpart of
``eagle_mpc_tpu.utils.log``). The level comes from ``EAGLE_MPC_TPU_LOG``
(error|warn|info|debug; default info) or ``set_level``.
"""

from __future__ import annotations

import os
import sys
import time

ERROR, WARN, INFO, DEBUG = 0, 1, 2, 3
_NAMES = {"error": ERROR, "warn": WARN, "info": INFO, "debug": DEBUG}
_COLORS = {ERROR: "\x1b[31m", WARN: "\x1b[33m", INFO: "\x1b[32m", DEBUG: "\x1b[36m"}
_TAGS = {ERROR: "ERROR", WARN: "WARN ", INFO: "INFO ", DEBUG: "DEBUG"}

_level = _NAMES.get(os.environ.get("EAGLE_MPC_TPU_LOG", "info").lower(), INFO)
_t0 = time.monotonic()


def set_level(level) -> None:
    global _level
    _level = _NAMES[level] if isinstance(level, str) else int(level)


def get_level() -> int:
    return _level


def _emit(level: int, *args) -> None:
    if level > _level:
        return
    color = _COLORS[level] if sys.stderr.isatty() else ""
    reset = "\x1b[0m" if color else ""
    msg = " ".join(str(a) for a in args)
    print(f"{color}[{_TAGS[level]} {time.monotonic() - _t0:9.3f}] {msg}{reset}",
          file=sys.stderr)


def error(*args) -> None:
    _emit(ERROR, *args)


def warn(*args) -> None:
    _emit(WARN, *args)


def info(*args) -> None:
    _emit(INFO, *args)


def debug(*args) -> None:
    _emit(DEBUG, *args)
