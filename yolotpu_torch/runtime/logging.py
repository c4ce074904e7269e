"""Leveled logging matching the reference runtime's verbosity contract.

Reference (``linux_app/src/yolo2_log.c:4-57``): env ``YOLO2_VERBOSE`` 0-3
(0=errors, 1=info, 2=per-layer, 3=debug), overridable by a ``-v`` CLI flag;
macros YOLO2_LOG_INFO / YOLO2_LOG_LAYER / YOLO2_LOG_DEBUG.

Mirrors ``yolotpu/runtime/logging.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import os
import sys

ERROR, INFO, LAYER, DEBUG = 0, 1, 2, 3
_level: int | None = None


def get_level() -> int:
    global _level
    if _level is None:
        try:
            _level = int(os.environ.get("YOLO2_VERBOSE", "1"))
        except ValueError:
            _level = 1
    return _level


def set_level(level: int) -> None:
    global _level
    _level = int(level)


def log(level: int, msg: str) -> None:
    if get_level() >= level:
        print(msg, file=sys.stderr if level == ERROR else sys.stdout, flush=True)


def info(msg: str) -> None:
    log(INFO, msg)


def layer(msg: str) -> None:
    log(LAYER, msg)


def debug(msg: str) -> None:
    log(DEBUG, msg)


def error(msg: str) -> None:
    log(ERROR, msg)
