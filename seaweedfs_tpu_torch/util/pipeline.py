"""Bounded-concurrency pipeline primitives for the data plane.

The gateway tier moves every byte serially while the EC kernels stream at
tens of GB/s: the filer fetches chunk k only after the client consumed
chunk k-1, and uploads chunk k before reading chunk k+1 off the socket.
The reference solved this with a prefetching ReaderCache
(`filer/reader_cache.go`) and concurrent `uploadReaderToChunks`
(`filer_server_handlers_write_autochunk.go`); these two primitives are the
shared shape both of those reduce to:

- ``prefetch_iter``  — ordered read-ahead over an iterable: up to
  ``window`` fetches in flight, results yielded strictly in input order.
- ``BoundedExecutor`` — overlapped writes: ``submit`` blocks once
  ``window`` tasks are in flight, ``drain`` returns results in submit
  order, and a failure path that lets the caller see EVERY task settled
  before cleaning up side effects (purging uploaded fids).

Both bound memory to window × item size by construction, and both ride the
pooled keep-alive transport in ``server/http_util.py`` — worker threads get
their own pooled sockets (the pool is thread-local), so a window of N keeps
N warm connections per peer, not N dials per chunk.

The port's copy of the JAX package's ``util/pipeline.py``.
"""

from __future__ import annotations

import contextvars
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional


def prefetch_iter(
    items: Iterable,
    fetch: Callable,
    window: int,
    key: Optional[Callable] = None,
):
    """Yield ``(item, fetch(item))`` pairs in input order with at most
    ``window`` results materialized at once (reader_cache.go MaybeCache:
    the read-ahead that hides per-chunk volume round-trips behind the
    bytes the client is still consuming).

    - Results come back strictly in input order; a slow fetch for item k
      never reorders k+1 ahead of it.
    - ``key(item)`` (default: the item itself) names the fetch for
      single-flight dedup: interleaved views over the same fid
      (A,B,A,B) share ONE in-flight fetch instead of racing duplicates.
    - The first fetch error propagates at that item's position — callers
      that consume the first pair eagerly keep their eager-first-piece
      error semantics.
    - Closing the generator shuts the pool down without waiting, so a
      client that disconnects mid-stream never wedges the handler thread
      on unconsumed read-ahead.

    ``window <= 1`` degenerates to the serial map (the serial baseline).
    """
    if window <= 1:
        for item in items:
            yield item, fetch(item)
        return
    key = key or (lambda item: item)
    it = iter(items)
    pool = ThreadPoolExecutor(
        max_workers=window, thread_name_prefix="prefetch"
    )
    # fetches run with the consumer's context (contextvars do not cross
    # pool threads on their own). Snapshot once, but enter a per-submit
    # copy — a Context can only be entered by one thread at a time, and
    # window>1 runs fetches concurrently
    ctx = contextvars.copy_context()
    # queued-but-unyielded entries; holding completed results in this
    # deque is what caps resident data at window × chunk size
    pending: deque = deque()
    by_key: dict = {}  # key → [future, refcount] for single-flight dedup
    try:
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    item = next(it)
                except StopIteration:
                    exhausted = True
                    break
                k = key(item)
                ent = by_key.get(k)
                if ent is None:
                    ent = by_key[k] = [
                        pool.submit(ctx.copy().run, fetch, item), 0
                    ]
                ent[1] += 1
                pending.append((item, k, ent[0]))
            if not pending:
                return
            item, k, fut = pending.popleft()
            try:
                result = fut.result()
            finally:
                ent = by_key[k]
                ent[1] -= 1
                if ent[1] == 0:
                    del by_key[k]
            yield item, result
    finally:
        # cancel queued work and return without joining: in-flight fetches
        # finish on their own threads; the consumer is never blocked here
        pool.shutdown(wait=False, cancel_futures=True)


class BoundedExecutor:
    """In-flight-window executor for overlapped writes
    (_write_autochunk.go uploadReaderToChunks: socket read of chunk k+1
    overlaps assign+encrypt+upload of chunk k).

    ``submit`` blocks while ``window`` tasks are in flight — the caller's
    producer loop (reading chunk bytes off a socket) self-throttles, so
    resident data stays at window × chunk size. After any task fails,
    the next ``submit`` raises that error instead of queueing more work.

    ``drain`` waits for EVERY submitted task to settle, then either
    returns all results in submit order or raises the first error — only
    after the window is empty, so a caller that must undo side effects
    (purge every uploaded fid) sees the complete set. ``abort`` is the
    error-path variant: settle everything, swallow task errors, shut down.
    """

    def __init__(self, window: int, name: str = "pipeline"):
        self.window = max(1, window)
        self._pool = ThreadPoolExecutor(
            max_workers=self.window, thread_name_prefix=name
        )
        self._slots = threading.Semaphore(self.window)
        self._futures: list = []
        self._first_error: Optional[BaseException] = None
        self._error_lock = threading.Lock()

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        if self._first_error is not None:
            # surface the task failure at the producer promptly (stop
            # consuming the socket); drain/abort still settles the window
            raise self._first_error
        self._slots.acquire()
        # each task carries the submitting thread's context (contextvars
        # do not cross pool threads on their own)
        ctx = contextvars.copy_context()

        def run():
            try:
                return ctx.run(fn, *args, **kwargs)
            except BaseException as e:
                with self._error_lock:
                    if self._first_error is None:
                        self._first_error = e
                raise
            finally:
                self._slots.release()

        self._futures.append(self._pool.submit(run))

    def drain(self) -> list:
        """Settle every task; return results in submit order or raise the
        first failure (after all have settled)."""
        err: Optional[BaseException] = None
        results = []
        for fut in self._futures:
            try:
                results.append(fut.result())
            except BaseException as e:
                if err is None:
                    err = e
        self._pool.shutdown(wait=True)
        if err is not None:
            raise err
        return results

    def abort(self) -> None:
        """Error-path settle: wait out every in-flight task (so the
        caller's cleanup sees the final side-effect set), swallow their
        errors — the original failure is what the caller reports."""
        for fut in self._futures:
            try:
                fut.result()
            # sweedlint: ok broad-except error-path settle; the caller re-raises the original failure
            except BaseException:  # noqa: BLE001 — error-path settle; the caller re-raises the original failure
                pass
        self._pool.shutdown(wait=True)
