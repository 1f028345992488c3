"""Leveled logger with ERR/INFO/DEBUG/TRACE parity.

The level comes from the env var AOCL_ENABLE_LOG and, matching the
reference (utils/utils.h:134-153), is re-read on every log call so tools
can flip it at run time. Format: ``[LEVEL] : file : func : line : msg``.
"""

from __future__ import annotations

import inspect
import os
import sys

ERR, INFO, DEBUG, TRACE = 1, 2, 3, 4
_LEVELS = {"ERR": ERR, "INFO": INFO, "DEBUG": DEBUG, "TRACE": TRACE}


def _level() -> int:
    return _LEVELS.get(os.environ.get("AOCL_ENABLE_LOG", "").strip().upper(), 0)


def _emit(level_name: str, msg: str, stream) -> None:
    frame = inspect.currentframe().f_back.f_back
    info = inspect.getframeinfo(frame)
    stream.write(f"[{level_name}] : {os.path.basename(info.filename)} : "
                 f"{info.function} : {info.lineno} : {msg}\n")


def log_err(msg: str) -> None:
    if _level() >= ERR:
        _emit("ERR", msg, sys.stderr)


def log_info(msg: str) -> None:
    if _level() >= INFO:
        _emit("INFO", msg, sys.stdout)


def log_debug(msg: str) -> None:
    if _level() >= DEBUG:
        _emit("DEBUG", msg, sys.stdout)


def log_trace(msg: str) -> None:
    if _level() >= TRACE:
        _emit("TRACE", msg, sys.stdout)


def log_trace_enter() -> None:
    log_trace("Enter")


def log_trace_exit() -> None:
    log_trace("Exit")
