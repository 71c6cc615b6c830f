"""The thread→loop byte channel of the asyncio serving core.

The port's copy of ``ThreadFlume`` from the JAX package's
``util/aio_pipeline.py``: the bounded channel the reactor's response path
rides (``server/aio.py``). Handler code, running in a worker thread and
byte for byte the threads-mode code, writes; the loop drains to the socket.
The window bounds resident bytes, so a slow client backpressures the
producing thread instead of buffering the body. The module's awaitable
read-ahead ``aprefetch_iter`` (ordered, at most ``window`` fetches in
flight, single-flight by key, close-without-wait; the awaitable mirror of
``util/pipeline.prefetch_iter``) drives the filer's native GET. The
awaitable executor (``AioBoundedExecutor``) serves the S3 gateway and is
not ported yet.
"""

from __future__ import annotations

import asyncio
import threading
from collections import deque
from typing import AsyncIterable, Callable, Iterable, Optional, Union
from .locks import make_lock
from .racecheck import instrument


async def _aiter(items: Union[Iterable, AsyncIterable]):
    """Uniform async view over a sync or async iterable."""
    if hasattr(items, "__aiter__"):
        async for item in items:
            yield item
    else:
        for item in items:
            yield item


async def aprefetch_iter(
    items: Union[Iterable, AsyncIterable],
    fetch: Callable,
    window: int,
    key: Optional[Callable] = None,
):
    """Async generator of ``(item, await fetch(item))`` pairs in input
    order with at most ``window`` fetches in flight — the awaitable
    mirror of ``util.pipeline.prefetch_iter`` (same ordering,
    single-flight-by-key, eager-first-error, and close semantics; see
    that docstring for the contract prose).

    ``fetch`` is a coroutine function. Closing the generator cancels
    fetches that nothing else references; ``window <= 1`` degenerates to
    the serial awaited map.
    """
    if window <= 1:
        async for item in _aiter(items):
            yield item, await fetch(item)
        return
    key = key or (lambda item: item)
    it = _aiter(items)
    pending: deque = deque()  # (item, k, task) in input order
    by_key: dict = {}  # key → [task, refcount] for single-flight dedup
    try:
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    item = await it.__anext__()
                except StopAsyncIteration:
                    exhausted = True
                    break
                k = key(item)
                ent = by_key.get(k)
                if ent is None:
                    ent = by_key[k] = [
                        asyncio.ensure_future(fetch(item)), 0
                    ]
                ent[1] += 1
                pending.append((item, k, ent[0]))
            if not pending:
                return
            item, k, task = pending.popleft()
            try:
                result = await asyncio.shield(task)
            finally:
                ent = by_key[k]
                ent[1] -= 1
                if ent[1] == 0:
                    del by_key[k]
            yield item, result
    finally:
        # close-without-wait: cancel every fetch no consumer will see;
        # shield above keeps a shared (deduped) task alive for the
        # earlier position still holding a reference
        for _item, _k, task in pending:
            task.cancel()
            # retrieve the (cancelled or failed) result so the loop does
            # not log "exception was never retrieved" for abandoned work
            task.add_done_callback(
                lambda t: t.cancelled() or t.exception()
            )


class ThreadFlumeClosed(Exception):
    """The loop side tore the channel down (peer gone / server stopping);
    producer writes raise this so handler threads stop generating."""


@instrument
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
        self._mu = make_lock("ThreadFlume._mu")
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
