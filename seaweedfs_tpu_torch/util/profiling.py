"""``-cpuprofile`` and ``-memprofile`` (`util/grace/pprof.go:11`
SetupProfiling), as the JAX package's ``util/profiling.py`` wires them.

cProfile profiles the CPU of the thread that calls ``setup_profiling`` (the
CLI's main thread), and its stats load with ``pstats`` (``python -m
pstats FILE``); tracemalloc records memory, written as its 200 largest
lines. Both are dumped at process exit, and on SIGTERM, which runs the exit
hooks first.
"""

from __future__ import annotations

import atexit
import signal
from typing import Optional

from . import glog

_cpu_profiler = None
_mem_path: Optional[str] = None


def setup_profiling(cpu_profile_path: str = "", mem_profile_path: str = "") -> None:
    global _cpu_profiler, _mem_path
    if cpu_profile_path and _cpu_profiler is None:
        import cProfile

        _cpu_profiler = cProfile.Profile()
        _cpu_profiler.enable()
        atexit.register(_dump_cpu, cpu_profile_path)
        glog.info("cpu profiling on → %s", cpu_profile_path)
    if mem_profile_path and _mem_path is None:
        import tracemalloc

        tracemalloc.start(10)
        _mem_path = mem_profile_path
        atexit.register(_dump_mem, mem_profile_path)
        glog.info("memory profiling on → %s", mem_profile_path)
    if cpu_profile_path or mem_profile_path:
        _hook_sigterm()


def _dump_cpu(path: str) -> None:
    global _cpu_profiler
    if _cpu_profiler is None:
        return
    _cpu_profiler.disable()
    _cpu_profiler.dump_stats(path)
    _cpu_profiler = None
    glog.info("cpu profile written to %s", path)


def _dump_mem(path: str) -> None:
    global _mem_path
    if _mem_path is None:
        return
    import tracemalloc

    snap = tracemalloc.take_snapshot()
    with open(path, "w") as f:
        for stat in snap.statistics("lineno")[:200]:
            f.write(f"{stat}\n")
    _mem_path = None
    glog.info("memory profile written to %s", path)


def _hook_sigterm() -> None:
    """On SIGTERM: flush the log, run the exit hooks (the dumps), then the
    previous handler, or exit 143 when there was none."""
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        glog.flush()
        atexit._run_exitfuncs()
        if callable(prev):
            prev(signum, frame)
        else:
            raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread
