"""Leveled logging in the style of the reference's glog (`weed/glog/glog.go`),
with the JAX package's ``util/glog.py`` surface and line format.

- Severities INFO/WARNING/ERROR/FATAL (``fatal`` flushes and exits 255).
- A verbosity gate ``V(n)`` set by ``-v`` (glog.go:1000), and per-module
  overrides ``-vmodule=pattern=N,...`` with glob patterns over the calling
  file's name (glog.go:283); a spec without ``=N`` or with a negative level
  is refused.
- Output to stderr, or with ``-logdir`` to a file there
  (``<prog>.<stamp>.<pid>.log``, rotated past ``MAX_BYTES``), where
  messages at or above ``-stderrthreshold`` are copied to stderr too
  (glog.go:41-48); ``-logtostderr`` keeps stderr only.

One line per message, byte for byte the JAX package's:

    I1017 00:00:00.000000 12345 volume_server:120] message

Usage:
    from seaweedfs_tpu_torch.util import glog
    glog.info("volume %d loaded", vid)
    glog.V(2).info("heartbeat: %s", beat)
    glog.add_flags(parser); glog.init_from_flags(args)
"""

from __future__ import annotations

import fnmatch
import io
import os
import sys
import threading
import time
import traceback
from typing import Optional, TextIO

from .locks import make_lock
from .racecheck import instrument

INFO, WARNING, ERROR, FATAL = 0, 1, 2, 3
_SEV_CHAR = "IWEF"
_SEV_NAME = {"INFO": INFO, "WARNING": WARNING, "ERROR": ERROR, "FATAL": FATAL}

# rotate the log file past this many bytes (glog's MaxSize is 1.8 GB)
MAX_BYTES = 256 * 1024 * 1024


@instrument
class _State:
    def __init__(self) -> None:
        self.verbosity = 0
        self.vmodule: list[tuple[str, int]] = []  # (pattern, level)
        self._vcache: dict[str, int] = {}  # module -> effective level
        self.to_stderr = True
        self.stderr_threshold = ERROR  # with file output
        self.log_dir: Optional[str] = None
        self._file: Optional[TextIO] = None
        self._file_bytes = 0
        self.lock = make_lock("_State.lock")

    def effective_level(self, module: str) -> int:
        lvl = self._vcache.get(module)
        if lvl is None:
            lvl = self.verbosity
            for pat, plvl in self.vmodule:
                if fnmatch.fnmatchcase(module, pat):
                    lvl = plvl
                    break
            self._vcache[module] = lvl
        return lvl

    def reset_cache(self) -> None:
        self._vcache.clear()

    def out_file_locked(self) -> Optional[TextIO]:
        """The log file, opened (or rotated) on demand; the caller holds
        ``lock``."""
        if self.log_dir is None:
            return None
        if self._file is None or self._file_bytes > MAX_BYTES:
            if self._file is not None:
                self._file.close()
            os.makedirs(self.log_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            prog = os.path.basename(sys.argv[0] or "weed")
            path = os.path.join(self.log_dir, f"{prog}.{stamp}.{os.getpid()}.log")
            self._file = open(path, "a", buffering=io.DEFAULT_BUFFER_SIZE)
            self._file_bytes = 0
        return self._file


_state = _State()


def _caller_module(depth: int = 2) -> str:
    name = os.path.basename(sys._getframe(depth).f_code.co_filename)
    return name.removesuffix(".py")


def _emit(sev: int, module: str, lineno: int, fmt: str, args: tuple) -> None:
    msg = (fmt % args) if args else fmt
    now = time.time()
    head = time.strftime("%m%d %H:%M:%S", time.localtime(now))
    line = (f"{_SEV_CHAR[sev]}{head}.{int(now % 1 * 1e6):06d} "
            f"{threading.get_ident() % 100000:5d} {module}:{lineno}] {msg}\n")
    with _state.lock:
        f = _state.out_file_locked()
        if f is not None:
            f.write(line)
            _state._file_bytes += len(line)
            if sev >= WARNING:
                f.flush()
        if _state.to_stderr or (f is not None and sev >= _state.stderr_threshold):
            sys.stderr.write(line)


def _log(sev: int, fmt: str, args: tuple) -> None:
    frame = sys._getframe(2)  # the caller of info()/warning()/V(n).info()
    module = os.path.basename(frame.f_code.co_filename).removesuffix(".py")
    _emit(sev, module, frame.f_lineno, fmt, args)
    if sev == FATAL:
        flush()
        os._exit(255)


def info(fmt: str, *args) -> None:
    _log(INFO, fmt, args)


def warning(fmt: str, *args) -> None:
    _log(WARNING, fmt, args)


def error(fmt: str, *args) -> None:
    _log(ERROR, fmt, args)


def fatal(fmt: str, *args) -> None:
    """Log, flush, and exit the process with status 255."""
    _log(FATAL, fmt, args)


def exception(fmt: str, *args) -> None:
    """error() plus the active exception's traceback (formatted before the
    traceback is appended: it may hold '%')."""
    msg = (fmt % args) if args else fmt
    _log(ERROR, msg + "\n" + traceback.format_exc(), ())


class _Verbose:
    """Result of V(n): truthy iff enabled; .info logs at INFO severity."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def info(self, fmt: str, *args) -> None:
        if self.enabled:
            _log(INFO, fmt, args)


_V_ON, _V_OFF = _Verbose(True), _Verbose(False)


def V(level: int) -> _Verbose:
    """The verbosity gate (glog.go:1000) for the calling file."""
    if not _state.vmodule:
        # no -vmodule: one int compare, no frame inspection
        return _V_ON if level <= _state.verbosity else _V_OFF
    return _V_ON if level <= _state.effective_level(_caller_module()) else _V_OFF


def set_verbosity(v: int) -> None:
    _state.verbosity = v
    _state.reset_cache()


def set_vmodule(spec: str) -> None:
    """Parse ``pattern=N,pattern2=M`` (glog.go:283); an empty spec clears."""
    mods: list[tuple[str, int]] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        pat, _, lvl = part.partition("=")
        if not lvl:
            raise ValueError(f"vmodule entry missing '=N': {part!r}")
        n = int(lvl)
        if n < 0:
            raise ValueError("negative value for vmodule level")
        mods.append((pat, n))
    _state.vmodule = mods
    _state.reset_cache()


def set_output(to_stderr: Optional[bool] = None, log_dir: Optional[str] = None,
               stderr_threshold: Optional[str] = None) -> None:
    with _state.lock:
        if to_stderr is not None:
            _state.to_stderr = to_stderr
        if log_dir is not None:
            _state.log_dir = log_dir or None
        if stderr_threshold is not None:
            _state.stderr_threshold = _SEV_NAME[stderr_threshold.upper()]


def flush() -> None:
    with _state.lock:
        if _state._file is not None:
            _state._file.flush()
    sys.stderr.flush()


def add_flags(parser) -> None:
    """The glog flag set on an argparse parser (glog.go:399-409)."""
    g = parser.add_argument_group("logging")
    g.add_argument("-v", type=int, default=0, metavar="LEVEL",
                   help="log verbosity for V-gated messages")
    g.add_argument("-vmodule", default="", metavar="pat=N,...",
                   help="per-module verbosity overrides (glob patterns)")
    g.add_argument("-logtostderr", action="store_true", default=None,
                   help="log to stderr instead of files (default when no -logdir)")
    g.add_argument("-logdir", default="", help="write log files under this dir")
    g.add_argument("-stderrthreshold", default="ERROR",
                   choices=["INFO", "WARNING", "ERROR", "FATAL"],
                   help="with -logdir, also copy logs at/above this severity to stderr")


def init_from_flags(args) -> None:
    set_verbosity(getattr(args, "v", 0) or 0)
    spec = getattr(args, "vmodule", "")
    if spec:
        set_vmodule(spec)
    log_dir = getattr(args, "logdir", "") or None
    to_stderr = getattr(args, "logtostderr", None)
    if to_stderr is None:
        to_stderr = log_dir is None
    set_output(to_stderr=to_stderr, log_dir=log_dir,
               stderr_threshold=getattr(args, "stderrthreshold", "ERROR"))
