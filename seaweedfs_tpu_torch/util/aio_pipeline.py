"""The thread→loop byte channel of the asyncio serving core.

The port's copy of ``ThreadFlume`` from the JAX package's
``util/aio_pipeline.py``: the bounded channel the reactor's response path
rides (``server/aio.py``). Handler code, running in a worker thread and
byte for byte the threads-mode code, writes; the loop drains to the socket.
The window bounds resident bytes, so a slow client backpressures the
producing thread instead of buffering the body. The module's awaitable
read-ahead and executor (``aprefetch_iter``, ``AioBoundedExecutor``) serve
the filer and S3 gateways and are not ported yet.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from typing import Optional


class ThreadFlumeClosed(Exception):
    """The loop side tore the channel down (peer gone / server stopping);
    producer writes raise this so handler threads stop generating."""


class ThreadFlume:
    """Bounded thread→loop byte channel.

    The reactor runs handler code in worker threads (so the threads-mode
    bytes-on-wire logic is reused verbatim) but owns the socket on the
    loop. The flume is the seam: the worker calls ``put`` (blocking once
    ``window`` chunks are queued — backpressure reaches the producing
    thread, which is what bounds a fast handler against a slow client),
    and the loop consumes via ``async for`` or ``get``.

    ``close_read`` poisons the channel from the loop side: queued chunks
    are dropped and producers unblock into ``ThreadFlumeClosed``.
    """

    # The window counts ITEMS, so a producer pushing whole large-chunk
    # bodies (32MB filer chunks) would hold window × chunk bytes queued
    # ahead of a slow socket. Byte payloads larger than this are sliced
    # at the put boundary so the real resident bound is window × 1MB;
    # non-bytes items (sendfile ops) pass through whole.
    MAX_PIECE = 1 << 20

    def __init__(self, loop: asyncio.AbstractEventLoop, window: int = 8):
        self._loop = loop
        self._window = max(1, window)
        self._mu = threading.Lock()
        self._chunks: deque = deque()
        self._space = threading.Semaphore(self._window)
        self._closed = False  # producer finished
        self._broken = False  # consumer gone
        self._waiter: Optional[asyncio.Future] = None  # loop-side wakeup

    # -- thread side --------------------------------------------------------
    def put(self, data: bytes, timeout: Optional[float] = None) -> None:
        if isinstance(data, (bytes, bytearray)) and \
                len(data) > self.MAX_PIECE:
            for i in range(0, len(data), self.MAX_PIECE):
                self._put_one(data[i:i + self.MAX_PIECE], timeout)
            return
        self._put_one(data, timeout)

    def _put_one(self, data, timeout: Optional[float]) -> None:
        if not self._space.acquire(timeout=timeout):
            raise TimeoutError("flume backpressure timeout")
        with self._mu:
            if self._broken:
                self._space.release()
                raise ThreadFlumeClosed()
            self._chunks.append(data)
            self._wake_locked()

    def close(self) -> None:
        """Producer is done; the loop side drains what is queued then
        sees end-of-stream."""
        with self._mu:
            self._closed = True
            self._wake_locked()

    # -- loop-producer side --------------------------------------------------
    def try_put(self, data) -> bool:
        """Non-blocking put for LOOP-side producers (native-async
        handlers share the connection's flume with bridged responses so
        bytes stay ordered). False when the window is full."""
        if not self._space.acquire(blocking=False):
            return False
        with self._mu:
            if self._broken:
                self._space.release()
                raise ThreadFlumeClosed()
            self._chunks.append(data)
            self._wake_locked()
        return True

    async def aput(self, data) -> None:
        """Awaitable put: polls the window without ever blocking the
        loop. The poll only spins while a slow client holds the window
        full — exactly when there is nothing better to do."""
        if isinstance(data, (bytes, bytearray)) and \
                len(data) > self.MAX_PIECE:
            for i in range(0, len(data), self.MAX_PIECE):
                piece = data[i:i + self.MAX_PIECE]
                while not self.try_put(piece):
                    await asyncio.sleep(0.005)
            return
        while not self.try_put(data):
            await asyncio.sleep(0.005)

    def _wake_locked(self) -> None:
        w, self._waiter = self._waiter, None
        if w is not None:
            self._loop.call_soon_threadsafe(
                lambda: w.done() or w.set_result(None)
            )

    # -- loop side ----------------------------------------------------------
    async def get(self) -> Optional[bytes]:
        """Next chunk, or None at end-of-stream."""
        while True:
            with self._mu:
                if self._chunks:
                    data = self._chunks.popleft()
                    self._space.release()
                    return data
                if self._closed or self._broken:
                    return None
                waiter = self._waiter = self._loop.create_future()
            await waiter

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        data = await self.get()
        if data is None:
            raise StopAsyncIteration
        return data

    def close_read(self) -> None:
        """Consumer gone: drop queued chunks and poison future puts.

        Dropped entries that carry a waiter (a queued ``_SendfileOp``
        whose producer thread is parked in ``op.wait()``) are rejected,
        not just discarded — silently dropping one leaves that worker
        blocked forever on an event nobody will ever set."""
        with self._mu:
            self._broken = True
            dropped = list(self._chunks)
            self._chunks.clear()
            self._wake_locked()
        for item in dropped:
            self._space.release()
            reject = getattr(item, "reject", None)
            if reject is not None:
                reject(ThreadFlumeClosed())
