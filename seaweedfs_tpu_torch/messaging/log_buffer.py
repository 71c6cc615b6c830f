"""In-memory message log with periodic flush: the port's copy of the JAX
package's ``messaging/log_buffer.py`` (reference `util/log_buffer/
log_buffer.go:24,56`). Appends accumulate in the active buffer; when the
buffer exceeds `flush_bytes` or `flush_interval` it is sealed, handed to the
flush function (persisted as a segment file), and kept in `prev_buffers` so
recent history stays readable from memory while persistence catches up.
The frame (``encode_message``) is the JAX package's, byte for byte.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional
from ..util.locks import make_lock

# flush_fn(start_ts_ns, stop_ts_ns, encoded_segment_bytes)
FlushFn = Callable[[int, int, bytes], None]


def encode_message(ts_ns: int, key: bytes, value: bytes) -> bytes:
    """Length-prefixed frame: 8B ts + 4B klen + key + 4B vlen + value."""
    return (
        ts_ns.to_bytes(8, "big")
        + len(key).to_bytes(4, "big")
        + key
        + len(value).to_bytes(4, "big")
        + value
    )


def decode_messages(blob: bytes) -> list[tuple[int, bytes, bytes]]:
    out = []
    pos = 0
    n = len(blob)
    while pos + 16 <= n:
        ts = int.from_bytes(blob[pos : pos + 8], "big")
        klen = int.from_bytes(blob[pos + 8 : pos + 12], "big")
        pos += 12
        key = blob[pos : pos + klen]
        pos += klen
        vlen = int.from_bytes(blob[pos : pos + 4], "big")
        pos += 4
        value = blob[pos : pos + vlen]
        pos += vlen
        out.append((ts, key, value))
    return out


class LogBuffer:
    def __init__(
        self,
        flush_fn: Optional[FlushFn] = None,
        flush_bytes: int = 4 * 1024 * 1024,
        flush_interval: float = 2.0,
        keep_prev: int = 8,
    ):
        self.flush_fn = flush_fn
        self.flush_bytes = flush_bytes
        self.flush_interval = flush_interval
        self.keep_prev = keep_prev
        self._buf = bytearray()
        self._msgs: list[tuple[int, bytes, bytes]] = []
        self._start_ts = 0
        self._prev: list[list[tuple[int, bytes, bytes]]] = []
        self._lock = make_lock("LogBuffer._lock")
        self._flushers: list[threading.Thread] = []
        self._last_flush = time.monotonic()
        self._stop = threading.Event()
        self.discarded = False  # True only via discard() (topic deletion)
        self._ticker = threading.Thread(target=self._tick, daemon=True)
        self._ticker.start()

    def append(self, key: bytes, value: bytes) -> int:
        with self._lock:
            if self._stop.is_set():
                # a handler holding a stale partition reference (obtained
                # before delete_topic evicted it) must not be able to seal
                # new segments into a deleted tree — drop, signalled by 0
                return 0
            ts = time.time_ns()
            if self._msgs and ts <= self._msgs[-1][0]:
                ts = self._msgs[-1][0] + 1  # strictly monotonic per partition
            if not self._msgs:
                self._start_ts = ts
            self._msgs.append((ts, key, value))
            self._buf += encode_message(ts, key, value)
            if len(self._buf) >= self.flush_bytes:
                self._seal_locked()
            return ts

    def _seal_locked(self) -> None:
        if not self._msgs:
            return
        msgs, blob = self._msgs, bytes(self._buf)
        start, stop = msgs[0][0], msgs[-1][0]
        self._prev.append(msgs)
        if len(self._prev) > self.keep_prev:
            self._prev = self._prev[-self.keep_prev :]
        self._msgs, self._buf = [], bytearray()
        self._last_flush = time.monotonic()
        if self.flush_fn:
            t = threading.Thread(
                target=self.flush_fn, args=(start, stop, blob), daemon=True
            )
            self._flushers = [f for f in self._flushers if f.is_alive()]
            self._flushers.append(t)
            t.start()

    def flush(self) -> None:
        with self._lock:
            self._seal_locked()

    def _tick(self) -> None:
        while not self._stop.wait(self.flush_interval / 2):
            with self._lock:
                if (
                    self._msgs
                    and time.monotonic() - self._last_flush > self.flush_interval
                ):
                    self._seal_locked()

    def read_since(self, ts_ns: int, limit: int = 1000):
        """Messages with ts > ts_ns still held in memory (active + prev)."""
        with self._lock:
            out = []
            for msgs in self._prev + [self._msgs]:
                for m in msgs:
                    if m[0] > ts_ns:
                        out.append(m)
                        if len(out) >= limit:
                            return out
            return out

    def memory_floor_ts(self) -> int:
        """Oldest ts still in memory (0 = everything is in memory)."""
        with self._lock:
            for msgs in self._prev + [self._msgs]:
                if msgs:
                    return msgs[0][0]
        return 0

    def close(self) -> None:
        self._stop.set()
        self.flush()

    def discard(self) -> None:
        """Stop WITHOUT persisting: drop pending messages and wait out any
        in-flight flush threads. For topic deletion — a flush landing after
        the topic tree is removed would resurrect it as orphan segments."""
        self._stop.set()
        with self._lock:
            self.discarded = True
            self._msgs, self._buf = [], bytearray()
            self._prev = []
            self.flush_fn = None  # no late _seal_locked may ever persist
            flushers = list(self._flushers)
            self._flushers = []
        for t in flushers:
            t.join(timeout=10)
