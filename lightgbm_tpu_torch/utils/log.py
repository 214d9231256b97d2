"""Logging with levels and a redirectable callback
(reference include/LightGBM/utils/log.h:71 ``LogLevel``/``Log``; the
callback redirect is what the reference Python package uses to route C++ log
lines to Python, log.h:90 ``ResetCallBack``).

Copy of ``lightgbm_tpu/utils/log.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

LEVEL_FATAL = -1
LEVEL_WARNING = 0
LEVEL_INFO = 1
LEVEL_DEBUG = 2

_verbosity = LEVEL_INFO
_callback: Optional[Callable[[str], None]] = None
# serializes sink swaps against emission so a message never lands on a
# half-replaced callback and concurrent writers can't interleave lines;
# reentrant so a callback may itself log or swap the sink
_emit_lock = threading.RLock()


def set_verbosity(level: int) -> None:
    global _verbosity
    _verbosity = level


def get_verbosity() -> int:
    return _verbosity


def register_log_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Reference c_api.h:54 LGBM_RegisterLogCallback."""
    global _callback
    with _emit_lock:
        _callback = cb


def _emit(msg: str) -> None:
    with _emit_lock:
        if _callback is not None:
            _callback(msg + "\n")
        else:
            sys.stdout.write(msg + "\n")


def log_debug(msg: str) -> None:
    if _verbosity >= LEVEL_DEBUG:
        _emit(f"[LightGBM-TPU] [Debug] {msg}")


def log_info(msg: str) -> None:
    if _verbosity >= LEVEL_INFO:
        _emit(f"[LightGBM-TPU] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _verbosity >= LEVEL_WARNING:
        _emit(f"[LightGBM-TPU] [Warning] {msg}")


class LightGBMError(Exception):
    pass


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)
