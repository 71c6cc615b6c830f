"""The device trace of a measured window, and what the host was doing.

``WindowTrace`` runs ``torch.profiler`` with CUDA activity only (CUPTI
records every kernel and copy of the process, whichever thread launched
it), and beside it, in a ``--trace 1`` run, a sampler thread that reads the
Python stacks of the process every ``SAMPLE_S`` seconds. A ``--trace 0``
run of a cell with an end-to-end metric from the device trace runs the
profiler alone. ``summary`` reduces the two to what the
per-layer readers and the result's ``device`` and ``breakdown`` take: the
device's busy time (the union of kernel, copy and memset intervals inside
the window), the kernels' summed time, the operations that took most time,
and the longest idle gaps, each named by the program's function that the
host's busy threads were in most often during it.

Kineto stamps device events in the host's wall clock (ns since the epoch),
which is what the sampler and the window's bounds are kept in.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

SAMPLE_S = 0.05
PROGRAM = "seaweedfs_tpu_torch"
# innermost Python functions of a thread that is waiting, not working
WAITING = {"wait", "select", "poll", "accept", "sleep", "get", "recv", "recv_into",
           "readinto", "_recv_bytes", "_poll", "acquire", "join", "epoll", "run_forever",
           "_run_once", "serve_forever", "readline"}


class WindowTrace:
    def __init__(self, sample: bool = True):
        self.prof = None
        self.sample = sample
        self.samples: list = []  # (wall ns, label)
        self._stop = threading.Event()
        self._sampler = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        if self.sample:
            self._sampler = threading.Thread(target=self._sample, daemon=True)
            self._sampler.start()

    def stop(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join()
        self.prof.__exit__(None, None, None)

    def _sample(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(SAMPLE_S):
            now = time.time_ns()
            for tid, frame in sys._current_frames().items():
                if tid == me or frame.f_code.co_name in WAITING:
                    continue
                label = _program_frame(frame)
                if label:
                    self.samples.append((now, label))

    def events(self) -> list:
        """[(name, start ns, end ns)] of the device's operations."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        return out


def _program_frame(frame):
    """``file:function`` of the innermost frame inside the program."""
    while frame is not None:
        path = frame.f_code.co_filename
        if PROGRAM in path:
            return f"{path[path.rindex(PROGRAM) + len(PROGRAM) + 1:]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summary(events: list, samples: list, t0_ns: int, t1_ns: int, top: int = 10) -> dict:
    """The window [t0_ns, t1_ns]'s device busy and kernel seconds, its
    operations by time and its longest idle gaps, named by the samples."""
    clipped = sorted((max(s, t0_ns), min(e, t1_ns), n) for n, s, e in events
                     if e > t0_ns and s < t1_ns)
    busy, gaps, cursor = 0, [], t0_ns
    for s, e, _ in clipped:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < t1_ns:
        gaps.append((cursor, t1_ns))
    by_name: collections.Counter = collections.Counter()
    kernel_ns = 0
    for s, e, n in clipped:
        by_name[n] += e - s
        if not is_copy(n):
            kernel_ns += e - s
    gaps.sort(key=lambda g: g[0] - g[1])
    stamps = sorted(samples)
    named = []
    for a, b in gaps[:top]:
        seen = collections.Counter(label for t, label in stamps if a <= t < b)
        named.append([seen.most_common(1)[0][0] if seen else "no busy program thread sampled",
                      (b - a) / 1e9])
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy / 1e9,
            "kernel_s": kernel_ns / 1e9, "operations": len(clipped),
            "device_ops": [[n, ns / 1e9] for n, ns in by_name.most_common(top)],
            "idle_gaps": named}
