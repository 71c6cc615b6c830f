"""Byte-rate throttling of background copies.

``WriteThrottler`` is the reference's `weed/util/throttler.go` design:
count bytes in ~100 ms windows; when a window exceeds its share of the
bytes/s budget, sleep in proportion to the overage. It paces compaction
(`volume_vacuum.go` compactionBytePerSecond) so maintenance IO does not
starve the data plane. An instance is not thread-safe: each compaction
makes its own.
"""

from __future__ import annotations

import time


class WriteThrottler:
    def __init__(self, bytes_per_second: int = 0):
        self.bytes_per_second = bytes_per_second
        self._counter = 0
        self._window_start = time.monotonic()

    def maybe_slowdown(self, delta: int) -> None:
        if self.bytes_per_second <= 0:
            return
        self._counter += delta
        now = time.monotonic()
        elapsed = now - self._window_start
        # settle the window once 100 ms have passed or its byte budget is
        # spent (the latter paces bursts shorter than a window)
        if elapsed > 0.1 or self._counter >= self.bytes_per_second // 10:
            expected = self._counter / self.bytes_per_second
            if expected > elapsed:
                time.sleep(expected - elapsed)
            self._counter = 0
            self._window_start = time.monotonic()
