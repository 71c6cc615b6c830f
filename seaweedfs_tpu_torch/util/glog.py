"""Leveled logging in the style of the reference's glog (`weed/glog/glog.go`).

Severities INFO/WARNING/ERROR on one stderr stream, and a verbosity
gate ``V(n)`` set by ``-v``. One line per message:

    I1017 00:00:00.000000 12345 volume_server:120] message

Usage:
    from seaweedfs_tpu_torch.util import glog
    glog.info("volume %d loaded", vid)
    glog.V(2).info("heartbeat: %s", beat)
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback

INFO, WARNING, ERROR = 0, 1, 2
_SEV_CHAR = "IWE"

_lock = threading.Lock()
_verbosity = 0


def _emit(sev: int, fmt: str, args: tuple) -> None:
    msg = (fmt % args) if args else fmt
    frame = sys._getframe(2)  # the caller of info()/warning()/V(n).info()
    module = os.path.basename(frame.f_code.co_filename).removesuffix(".py")
    now = time.time()
    head = time.strftime("%m%d %H:%M:%S", time.localtime(now))
    line = (f"{_SEV_CHAR[sev]}{head}.{int(now % 1 * 1e6):06d} "
            f"{threading.get_ident() % 100000:5d} {module}:{frame.f_lineno}] {msg}\n")
    with _lock:
        sys.stderr.write(line)


def info(fmt: str, *args) -> None:
    _emit(INFO, fmt, args)


def warning(fmt: str, *args) -> None:
    _emit(WARNING, fmt, args)


def error(fmt: str, *args) -> None:
    _emit(ERROR, fmt, args)


def exception(fmt: str, *args) -> None:
    """error() plus the active exception's traceback (formatted before the
    traceback is appended: it may hold '%')."""
    msg = (fmt % args) if args else fmt
    _emit(ERROR, msg + "\n" + traceback.format_exc(), ())


class _Verbose:
    """Result of V(n): truthy iff enabled; .info logs at INFO severity."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def info(self, fmt: str, *args) -> None:
        if self.enabled:
            _emit(INFO, fmt, args)


_V_ON, _V_OFF = _Verbose(True), _Verbose(False)


def V(level: int) -> _Verbose:
    """The verbosity gate (glog.go:1000)."""
    return _V_ON if level <= _verbosity else _V_OFF


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = v
