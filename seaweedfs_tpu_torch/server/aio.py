"""Asyncio serving core: the event-loop reactor behind ``SWEED_SERVING=aio``
(the default).

The port of the JAX package's ``server/aio.py``. Thread-per-connection
pins an OS thread per idle keep-alive connection; this reactor inverts the
shape:

- Connections live on ONE event loop; an idle keep-alive connection costs a
  parked coroutine, not a thread.
- Request heads are parsed on the loop; the handler then runs in a small
  bounded worker pool, and it is the same handler code the threads core
  runs (``JsonHandler``): the shim below instantiates the untouched handler
  class against loop-bridged rfile/wfile/connection objects, so routing,
  parsers and error bytes cannot drift between the cores.
- Response bytes flow thread -> loop through a bounded ``ThreadFlume``
  (``util/aio_pipeline.py``): a slow client backpressures the producing
  worker at ``window`` chunks instead of the body being buffered.
- Zero-copy replies (``SendfileBody``) ride ``loop.sendfile``: the flume
  carries an ordered sendfile op, so kernel-to-socket bytes interleave
  correctly with the header bytes.
- Hot read routes (``native_routes``) run as coroutines on the loop with no
  worker hop; every edge falls back to the bridged path.
- Admission control is shared with the threads core: past the
  ``SWEED_MAX_INFLIGHT`` watermark a fresh connection gets the canned 503 +
  Retry-After, and keep-alive replies carry Connection: close.
- An idle-connection reaper closes peers that owe a request head longer
  than ``SWEED_IDLE_TIMEOUT`` (the slow-loris defence).

- TLS: with an ``ssl_context`` the listener wraps each connection
  (``asyncio.start_server(ssl=...)``; handshakes run on the loop, one per
  connection, never blocking the accept).
- The request choke point of ``http_util`` holds on the native path too:
  the tenant governor admits first (its shed is a 503 with ``Retry-After``
  on a kept-alive connection), a spent ``X-Sweed-Deadline`` bridges to the
  worker path for the one canonical 504, and the route runs inside a server
  span. Bridged requests carry the loop task's context into the worker
  pool, so tracing and deadlines cross the bridge.

The lifecycle mirrors the socketserver surface (``start``/``shutdown``/
``server_close``/``server_address``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import email.utils
import io
import json
import os
import socket
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import Optional

from ..stats import trace as _trace
from ..util import deadline as _deadline
from ..util import faultpoints, glog
from ..util.aio_pipeline import ThreadFlume, ThreadFlumeClosed
from ..util.racecheck import instrument
from ..util.throttler import GOVERNOR, INTERNAL_TENANT
from .http_util import (
    NATIVE_FALLBACK,
    SERVING,
    AsyncStreamBody,
    SendfileBody,
    admission_reject_response,
    count_qos_decision,
    dynamic_retry_after,
    observe_tenant_request,
    request_tenant,
    serving_watermark,
)


def _aio_workers() -> int:
    raw = os.environ.get("SWEED_AIO_WORKERS", "32").strip()
    if not (raw.isascii() and raw.isdigit()):
        return 32
    return max(1, int(raw))


def _env_seconds(name: str, default: int) -> float:
    raw = os.environ.get(name, str(default)).strip()
    if not (raw.isascii() and raw.isdigit()):
        return float(default)
    return float(int(raw))


def idle_timeout_seconds() -> float:
    """Reap a connection idle (no request head arriving) this long: the
    slow-loris defense — a peer dribbling one header byte per minute
    holds a parked coroutine forever otherwise. 0 disables."""
    return _env_seconds("SWEED_IDLE_TIMEOUT", 60)


def handler_deadline_seconds() -> float:
    """Reap a connection whose in-flight request exceeds this wall-clock
    budget. Off by default (0): long-running streams — volume copy,
    tail-reads — are legitimate; deployments that want a hard ceiling
    opt in."""
    return _env_seconds("SWEED_HANDLER_DEADLINE", 0)


def reap_interval_seconds() -> float:
    return max(0.5, _env_seconds("SWEED_REAP_INTERVAL", 5))


class _SendfileOp:
    """Ordered zero-copy marker in the response flume: the pump executes
    it with loop.sendfile once every byte queued before it has reached
    the transport, then wakes the waiter — a worker thread (bridged
    path, threading.Event) or a native coroutine (loop-side future)."""

    def __init__(self, file, offset: int, count: Optional[int],
                 loop: Optional[asyncio.AbstractEventLoop] = None):
        self.file, self.offset, self.count = file, offset, count
        self._evt = threading.Event() if loop is None else None
        self._fut = loop.create_future() if loop is not None else None
        self._result = 0
        self._exc: Optional[BaseException] = None

    def resolve(self, sent: int) -> None:
        self._result = sent
        if self._fut is not None:
            # the pump runs on the owning loop, so setting directly is safe
            if not self._fut.done():
                self._fut.set_result(sent)
        else:
            self._evt.set()

    def reject(self, exc: BaseException) -> None:
        self._exc = exc
        if self._fut is not None:
            if not self._fut.done():
                self._fut.set_exception(exc)
        else:
            self._evt.set()

    def wait(self) -> int:
        self._evt.wait()
        if self._exc is not None:
            raise self._exc
        return self._result

    async def await_sent(self) -> int:
        return await self._fut


class _WfileBridge:
    """Handler-facing wfile: buffers small writes, pushes blocks into the
    connection's flume (bounded — blocking the worker, not the loop, when
    the client reads slowly). A torn-down flume surfaces as
    BrokenPipeError so untouched handler error paths do the right thing."""

    def __init__(self, flume: ThreadFlume, hw: int = 64 << 10):
        self._flume = flume
        self._buf: list = []
        self._size = 0
        self._hw = hw

    def write(self, data) -> int:
        data = bytes(data)
        self._buf.append(data)
        self._size += len(data)
        if self._size >= self._hw:
            self.flush()
        return len(data)

    def flush(self) -> None:
        if not self._buf:
            return
        blob = b"".join(self._buf)
        self._buf.clear()
        self._size = 0
        try:
            self._flume.put(blob)
        except ThreadFlumeClosed:
            raise BrokenPipeError("client connection gone") from None


class _RfileBridge:
    """Handler-facing rfile: request-head bytes come from the loop-parsed
    buffer; body bytes bridge to the connection's StreamReader via
    run_coroutine_threadsafe. Honors the socket-timeout surface that
    drain_refused_body drives through handler.connection."""

    def __init__(self, loop: asyncio.AbstractEventLoop, reader):
        self._loop = loop
        self._reader = reader
        self._head = io.BytesIO()
        self.timeout: Optional[float] = None

    def set_head(self, rest: bytes) -> None:
        self._head = io.BytesIO(rest)

    def readline(self, limit: int = -1) -> bytes:
        line = self._head.readline(limit)
        if line:
            return line
        # headers always live in the head buffer; only pathological
        # callers land here — byte-at-a-time is fine for them
        out = bytearray()
        while True:
            b = self.read(1)
            if not b:
                break
            out += b
            if b == b"\n" or (0 < limit <= len(out)):
                break
        return bytes(out)

    def read(self, n: int = -1) -> bytes:
        if n is not None and n >= 0:
            got = self._head.read(n)
            need = n - len(got)
            if need <= 0:
                return got
            return got + self._await(self._read_wire(need))
        return self._head.read() + self._await(self._read_wire(None))

    async def _read_wire(self, n: Optional[int]) -> bytes:
        out = bytearray()
        while n is None or len(out) < n:
            want = (1 << 20) if n is None else min(n - len(out), 1 << 20)
            chunk = await self._reader.read(want)
            if not chunk:
                break
            out += chunk
        return bytes(out)

    def _await(self, coro) -> bytes:
        try:
            fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        except RuntimeError:
            raise ConnectionResetError("event loop gone") from None
        try:
            return fut.result(self.timeout)
        except concurrent.futures.TimeoutError:
            # distinct from builtin TimeoutError until 3.11 — re-raise as
            # socket.timeout (an OSError), drain_refused_body's cue
            fut.cancel()
            raise socket.timeout("timed out") from None
        except asyncio.CancelledError:
            raise ConnectionResetError("connection torn down") from None


class _ShimConn:
    """Handler-facing `connection`: the timeout knobs drain_refused_body
    needs, plus the socket.sendfile surface the zero-copy reply path
    calls — routed through the flume so the bytes stay ordered."""

    def __init__(self, rfile: _RfileBridge, flume: ThreadFlume):
        self._rfile = rfile
        self._flume = flume

    def settimeout(self, t) -> None:
        # sweedlint: ok cross-domain-race per-connection shim; only the one worker serving this connection writes it
        self._rfile.timeout = t

    def gettimeout(self):
        return self._rfile.timeout

    def sendfile(self, file, offset: int = 0, count=None) -> int:
        op = _SendfileOp(file, offset, count)
        try:
            self._flume.put(op)
            # wait() raises ThreadFlumeClosed too when close_read
            # rejects the op after it was queued but before the pump
            # reached it
            return op.wait()
        except ThreadFlumeClosed:
            raise BrokenPipeError("client connection gone") from None


# -- native-async fast path ---------------------------------------------------
class _HeaderView:
    """Case-insensitive read-only view over parsed request headers — the
    subset of the email.message surface the reused handler helpers
    (_auth_ok, classify_tenant, range parsing) actually touch."""

    __slots__ = ("_d",)

    def __init__(self, pairs):
        d = {}
        for k, v in pairs:
            d[k.lower()] = v  # duplicates: last wins (hot path only)
        self._d = d

    def get(self, name, default=None):
        return self._d.get(name.lower(), default)

    def __contains__(self, name) -> bool:
        return name.lower() in self._d

    def items(self):
        return self._d.items()


class NativeRequest:
    """The request surface a native-async route coroutine sees: just
    enough of the BaseHTTPRequestHandler shape that the sync helpers the
    hot paths reuse verbatim (_auth_ok, _range_reply, _sendfile_reply's
    header-population side) run unchanged against it."""

    __slots__ = ("command", "path", "headers", "client_address",
                 "extra_headers", "close_connection", "server")

    def __init__(self, command: str, path: str, headers: _HeaderView,
                 client_address: tuple, server):
        self.command = command
        self.path = path
        self.headers = headers
        self.client_address = client_address
        self.extra_headers: Optional[dict] = None
        self.close_connection = False
        self.server = server


def _parse_head_headers(rest: bytes) -> Optional[_HeaderView]:
    """Header block (bytes after the request line) -> view, or None when
    malformed (native punts; the bridged parser owns the error bytes)."""
    pairs = []
    try:
        for line in rest.decode("latin-1").split("\r\n"):
            if not line:
                continue
            k, sep, v = line.partition(":")
            if not sep or not k or k != k.strip():
                return None
            pairs.append((k, v.strip()))
    except UnicodeDecodeError:  # latin-1 never raises; defensive
        return None
    return _HeaderView(pairs)


_RESPONSE_PHRASES = BaseHTTPRequestHandler.responses


def _native_response_head(handler_cls, status: int,
                          headers: list) -> bytes:
    """Response head byte-compatible with BaseHTTPRequestHandler's
    send_response (same status phrase, Server and Date headers) so
    threads-vs-native wire parity holds for everything a client can
    key on."""
    phrase = _RESPONSE_PHRASES.get(status, ("", ""))[0]
    server = (f"{handler_cls.server_version} "
              f"{BaseHTTPRequestHandler.sys_version}")
    lines = [
        f"HTTP/1.1 {status} {phrase}",
        f"Server: {server}",
        f"Date: {email.utils.formatdate(usegmt=True)}",
    ]
    for k, v in headers:
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _expect_100_and_flush(h) -> bool:
    """handle_expect_100 writes '100 Continue' into a buffering wfile;
    the interim response must hit the wire before the client will send
    the body, so flush explicitly (the real socket wfile is unbuffered)."""
    ok = BaseHTTPRequestHandler.handle_expect_100(h)
    h.wfile.flush()
    return ok


def _run_request(handler_cls, server, conn, rfile, wfile,
                 client_address, raw_requestline) -> bool:
    """Run ONE parsed-head request through the untouched handler class in
    a worker thread; returns close_connection. This is
    BaseHTTPRequestHandler.handle_one_request minus the socket plumbing:
    the handler instance is built bare (__new__) against the bridges, so
    every subclass behavior — routing, parsers, error bytes, logging —
    is the threads-mode code verbatim."""
    h = handler_cls.__new__(handler_cls)
    h.server = server
    h.client_address = client_address
    h.connection = conn
    h.rfile = rfile
    h.wfile = wfile
    h.close_connection = True
    h.raw_requestline = raw_requestline
    h.requestline = ""
    h.command = ""
    h.request_version = handler_cls.default_request_version
    h.handle_expect_100 = lambda: _expect_100_and_flush(h)
    try:
        if not h.parse_request():
            # parse_request already sent the error response
            h.wfile.flush()
            return True
        mname = "do_" + h.command
        if not hasattr(h, mname):
            h.send_error(
                501, "Unsupported method (%r)" % h.command
            )
            h.wfile.flush()
            return bool(h.close_connection)
        getattr(h, mname)()
        h.wfile.flush()
    except (BrokenPipeError, ConnectionResetError, TimeoutError):
        h.close_connection = True
    except Exception:
        glog.exception("aio handler failed (%s)",
                       getattr(h, "requestline", ""))
        h.close_connection = True
    return bool(h.close_connection)


@instrument
class AioHTTPServer:
    """Event-loop serving core with the socketserver lifecycle surface.

    One daemon thread runs the loop; `start()` blocks until the listener
    is bound (raising bind errors in the caller, like ThreadingHTTPServer
    does) and fills in `server_address` — port 0 works."""

    def __init__(self, handler_cls, host: str, port: int, ssl_context=None):
        self.handler_cls = handler_cls
        self.host, self.port = host, port
        self._ssl = ssl_context
        self.server_address = (host, port)
        self._pool = ThreadPoolExecutor(
            max_workers=_aio_workers(), thread_name_prefix="aio-worker"
        )
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._stop_evt: Optional[asyncio.Event] = None
        self._stopped = False
        # loop-confined: every mutation happens on the loop thread
        self._conns: set = set()
        self._conn_tasks: set = set()
        # writer -> [phase, deadline, task] for the reaper ("idle" while
        # waiting on a request head, "handler" while one is in flight)
        self._conn_meta: dict = {}
        # (method, prefix) -> coroutine for the native fast path; route
        # SELECTION still walks handler_cls.routes in order so a native
        # prefix can never shadow a longer bridged one
        self._native_map = {
            (m, p): fn
            for m, p, fn in getattr(handler_cls, "native_routes", [])
        }
        self._native_list = list(
            getattr(handler_cls, "native_routes", [])
        )
        SERVING.register_server(self)

    # -- socketserver-compatible surface ------------------------------------
    def start(self) -> "AioHTTPServer":
        self._thread = threading.Thread(
            target=self._thread_main, name="aio-serve", daemon=True
        )
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._startup_error is not None:
            raise self._startup_error
        return self

    def shutdown(self) -> None:
        loop, evt = self._loop, self._stop_evt
        if loop is None or evt is None or self._stopped:
            return
        self._stopped = True
        try:
            loop.call_soon_threadsafe(evt.set)
        except RuntimeError:
            return  # loop already closed
        if self._thread is not None:
            self._thread.join(timeout=10)

    def server_close(self) -> None:
        self.shutdown()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def inflight_count(self) -> int:
        return len(self._conns)

    def overloaded(self) -> bool:
        wm = serving_watermark()
        return wm > 0 and len(self._conns) >= wm

    # -- loop internals ------------------------------------------------------
    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._main())
        except Exception as e:
            if not self._ready.is_set():
                # sweedlint: ok cross-domain-race startup handshake: the write happens-before _ready.set(); readers wait on _ready
                self._startup_error = e
                self._ready.set()
            else:
                glog.exception("aio serving loop died")
        finally:
            try:
                loop.close()
            # sweedlint: ok broad-except loop teardown best-effort; process is moving on
            except Exception:  # noqa: BLE001 — teardown is best effort
                pass

    async def _main(self) -> None:
        self._stop_evt = asyncio.Event()
        try:
            server = await asyncio.start_server(
                self._client, self.host, self.port,
                ssl=self._ssl, limit=1 << 20, backlog=2048,
            )
        except BaseException as e:
            self._startup_error = e
            self._ready.set()
            return
        addr = server.sockets[0].getsockname()
        self.server_address = (addr[0], addr[1])
        lag = asyncio.ensure_future(self._lag_monitor())
        reaper = asyncio.ensure_future(self._reaper())
        self._ready.set()
        await self._stop_evt.wait()
        lag.cancel()
        reaper.cancel()
        server.close()
        # sever live keep-alive connections, same contract as the
        # threads core: a stopped server must not keep answering. This
        # comes before wait_closed(), which (Python 3.12+) waits for every
        # connection to close: an idle pooled keep-alive peer would hold it
        # until the join in shutdown() timed out
        if self._ssl is not None:
            # a closed TLS transport waits for the peer's close_notify
            # (ssl_shutdown_timeout, 30 s): abort instead
            for writer in list(self._conns):
                writer.transport.abort()
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await server.wait_closed()

    async def _reaper(self) -> None:
        """Deadline-aware connection reaper: kills slow-loris peers (an
        "idle" connection is one that owes us a request head — a
        half-dribbled head still counts as idle) and, when a handler
        deadline is configured, requests stuck in flight. Reaping
        cancels the connection task; its finally-block teardown closes
        the transport and any in-flight extent fds."""
        while True:
            await asyncio.sleep(reap_interval_seconds())
            now = self._loop.time()
            for writer, meta in list(self._conn_meta.items()):
                phase, deadline, task = meta
                if deadline is None or now <= deadline:
                    continue
                self._conn_meta.pop(writer, None)
                SERVING.note_reaped(
                    "idle" if phase == "idle" else "deadline"
                )
                glog.V(1).info("reaping %s connection past deadline",
                               phase)
                task.cancel()

    async def _lag_monitor(self) -> None:
        """Publish scheduled-vs-ran delta: how late a timer fires is how
        long something hogged the loop (a blocking call on the loop)."""
        interval = 0.2
        while True:
            t0 = self._loop.time()
            await asyncio.sleep(interval)
            SERVING.note_loop_lag(self._loop.time() - t0 - interval)

    async def _pump(self, flume: ThreadFlume, writer) -> None:
        """Drain the response flume to the transport; on client death,
        poison the flume so producing workers unwind promptly."""
        try:
            async for item in flume:
                if isinstance(item, _SendfileOp):
                    try:
                        await writer.drain()
                        sent = await self._loop.sendfile(
                            writer.transport, item.file,
                            item.offset, item.count, fallback=True,
                        )
                    except BaseException as e:
                        item.reject(e)
                        raise
                    item.resolve(sent)
                else:
                    writer.write(item)
                    await writer.drain()
        except asyncio.CancelledError:
            flume.close_read()
            raise
        except Exception:
            flume.close_read()

    async def _client(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            await self._serve_connection(reader, writer)
        finally:
            self._conn_tasks.discard(task)

    async def _serve_connection(self, reader, writer) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(
                    _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
        wm = serving_watermark()
        if wm > 0 and len(self._conns) >= wm:
            SERVING.note_rejected()
            try:
                writer.write(admission_reject_response())
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            writer.close()
            return
        self._conns.add(writer)
        flume = ThreadFlume(self._loop, window=8)
        pump = asyncio.ensure_future(self._pump(flume, writer))
        rfile = _RfileBridge(self._loop, reader)
        wfile = _WfileBridge(flume)
        conn = _ShimConn(rfile, flume)
        peer = writer.get_extra_info("peername") or ("", 0)
        client_address = (peer[0], peer[1] if len(peer) > 1 else 0)
        idle_to = idle_timeout_seconds()
        hdl_to = handler_deadline_seconds()
        meta = ["idle", None, asyncio.current_task()]
        self._conn_meta[writer] = meta
        try:
            while True:
                meta[0] = "idle"
                meta[1] = (self._loop.time() + idle_to) if idle_to > 0 \
                    else None
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    break  # clean idle close (or torn mid-head: moot)
                except asyncio.LimitOverrunError:
                    await self._canned(
                        flume, pump, writer,
                        b"HTTP/1.1 431 Request Header Fields Too Large"
                        b"\r\nContent-Length: 0\r\n"
                        b"Connection: close\r\n\r\n",
                    )
                    break
                except (ConnectionError, OSError):
                    break
                meta[0] = "handler"
                meta[1] = (self._loop.time() + hdl_to) if hdl_to > 0 \
                    else None
                idx = head.find(b"\r\n")
                raw_requestline = head[: idx + 2]
                rfile.set_head(head[idx + 2:])
                try:
                    native_close = await self._maybe_native(
                        raw_requestline, head[idx + 2:], client_address,
                        flume, pump,
                    )
                except (ConnectionError, OSError):
                    break  # peer tore the socket mid-reply (RST): done
                if native_close is not NATIVE_FALLBACK:
                    if native_close:
                        break
                    continue
                # run_in_executor does not carry contextvars (only task
                # creation copies them): copy the loop task's context, so
                # the trace and deadline cross the bridge
                ctx = contextvars.copy_context()
                try:
                    close = await self._loop.run_in_executor(
                        self._pool, ctx.run, _run_request,
                        self.handler_cls, self, conn, rfile, wfile,
                        client_address, raw_requestline,
                    )
                except RuntimeError:
                    break  # worker pool already shut down: server stopping
                if close:
                    break
        except asyncio.CancelledError:
            pass  # server teardown severs this connection
        finally:
            # normal close: let the pump DRAIN queued response bytes
            # (close marks end-of-stream) before poisoning; poisoning
            # first would truncate the final keep-alive response
            flume.close()
            try:
                await asyncio.wait_for(asyncio.shield(pump), timeout=15)
            except BaseException:
                # wedged or cancelled pump; the connection dies either way
                pump.cancel()
            flume.close_read()  # unblock any producer thread still stuck
            try:
                await pump
            # sweedlint: ok broad-except pump already poisoned the flume; connection is closing
            except BaseException:  # noqa: BLE001 — the connection is closing
                pass
            self._conn_meta.pop(writer, None)
            self._conns.discard(writer)
            try:
                writer.close()
            # sweedlint: ok broad-except transport may already be gone
            except Exception:  # noqa: BLE001 — the transport may be gone
                pass

    # -- native fast path ----------------------------------------------------
    def _native_route(self, method: str, path: str):
        """The native coroutine for (method, path), or None. Selection
        walks handler_cls.routes in ORDER — the same route the bridged
        path would take — so a native ("GET", "/") can never shadow a
        longer bridged prefix like "/status". Handler classes without a
        routes table match native_routes directly."""
        routes = getattr(self.handler_cls, "routes", None)
        if routes:
            for m, prefix, _fn in routes:
                if m == method and path.startswith(prefix):
                    fn = self._native_map.get((m, prefix))
                    return (fn, prefix) if fn is not None else None
            return None
        for m, prefix, fn in self._native_list:
            if m == method and path.startswith(prefix):
                return fn, prefix
        return None

    async def _maybe_native(self, raw_requestline: bytes,
                            head_rest: bytes, client_address: tuple,
                            flume, pump):
        """Serve the request natively on the loop when a native route
        matches and the request is plain (no body, no Expect, clean
        HTTP/1.1). Returns NATIVE_FALLBACK to run the bridged path —
        which re-parses from the untouched head buffer, so falling back
        costs nothing and cannot drift — else close_connection."""
        if not self._native_map and not self._native_list:
            return NATIVE_FALLBACK
        if faultpoints.active():
            # chaos parity: fault kinds like delay/serial-delay block;
            # the bridged worker path absorbs them off the loop
            return NATIVE_FALLBACK
        try:
            rl = raw_requestline.decode("latin-1").rstrip("\r\n")
            method, target, version = rl.split(" ")
        except ValueError:
            return NATIVE_FALLBACK
        if version != "HTTP/1.1" or not target.startswith("/"):
            return NATIVE_FALLBACK
        parsed = urllib.parse.urlsplit(target)
        hit = self._native_route(method, parsed.path)
        if hit is None:
            return NATIVE_FALLBACK
        headers = _parse_head_headers(head_rest)
        if headers is None:
            return NATIVE_FALLBACK
        if "Expect" in headers or "Transfer-Encoding" in headers:
            return NATIVE_FALLBACK
        cl = (headers.get("Content-Length") or "0").strip() or "0"
        if not (cl.isascii() and cl.isdigit()) or int(cl) != 0:
            return NATIVE_FALLBACK
        return await self._native_dispatch(
            hit[0], hit[1], method, parsed, headers, client_address,
            flume, pump,
        )

    async def _native_dispatch(self, fn, prefix: str, method: str,
                               parsed, headers, client_address: tuple,
                               flume, pump):
        tenant = request_tenant(headers, client_address[0])
        decision, wait = GOVERNOR.admit(tenant)
        if decision == "shed":
            # the connection survives a shed: a forced close turns every
            # over-rate request into accept and task churn on this loop
            count_qos_decision(tenant, "shed")
            body = json.dumps({"error": "tenant over rate"}).encode()
            head = _native_response_head(self.handler_cls, 503, [
                ("Content-Type", "application/json"),
                ("Content-Length", str(len(body))),
                ("Retry-After", str(dynamic_retry_after())),
            ])
            try:
                await flume.aput(head + body)
            except ThreadFlumeClosed:
                pass
            return False
        if decision == "delay":
            count_qos_decision(tenant, "delay")
            await asyncio.sleep(wait)
        elif GOVERNOR.enabled() and tenant != INTERNAL_TENANT:
            count_qos_decision(tenant, "ok")
        t0 = time.monotonic()
        query = {
            k: v[0]
            for k, v in urllib.parse.parse_qs(parsed.query).items()
        }
        # a spent budget bridges to the worker path, which renders the one
        # canonical 504 and cancelled span
        ddl = (_deadline.parse_header(headers.get(_deadline.DEADLINE_HEADER))
               if _deadline.enabled() else None)
        if ddl is not None and ddl <= time.time():
            SERVING.note_native_fallback()
            return NATIVE_FALLBACK
        req = NativeRequest(method, parsed.path, headers,
                            client_address, self)
        # the span's contextvar window is task-scoped: safe in a coroutine
        with _trace.start_span(
            f"{method} {prefix}",
            service=getattr(self.handler_cls, "trace_service", "http"),
            parent_header=headers.get(_trace.TRACE_HEADER),
            path=parsed.path,
        ) as span:
            try:
                with _deadline.scope(ddl):
                    result = await fn(req, parsed.path, query)
            except asyncio.CancelledError:
                raise
            except Exception:
                # nothing has been written yet: the bridged path re-runs the
                # request and produces its canonical error bytes
                glog.exception("native %s %s failed; bridging",
                               method, parsed.path)
                SERVING.note_native_fallback()
                return NATIVE_FALLBACK
            if result is NATIVE_FALLBACK:
                SERVING.note_native_fallback()
                return NATIVE_FALLBACK
            status, payload = result[0], result[1]
            extra = dict(req.extra_headers or {})
            if len(result) > 2 and result[2]:
                extra.update(result[2])
            if span is not None:
                span.tags["status"] = status
                if status >= 500:
                    # sweedlint: ok cross-domain-race per-request span; created and finished on the one task/thread serving the request
                    span.status = "error"
                extra.setdefault(_trace.TRACE_ID_HEADER, span.trace_id)
            close = (
                req.close_connection
                or (headers.get("Connection") or "").lower() == "close"
            )
            close = await self._write_native(
                status, payload, extra, flume, pump,
                head_only=(method == "HEAD"), close=close,
            )
        dt = time.monotonic() - t0
        SERVING.note_native()
        SERVING.note_request_seconds(dt)
        observe_tenant_request(tenant, dt)
        glog.V(2).info("%s %s -> %d (native)", method, parsed.path,
                       status)
        return close

    async def _write_native(self, status: int, payload, extra: dict,
                            flume, pump, head_only: bool,
                            close: bool) -> bool:
        """Format and queue a native response through the connection's
        flume — the SAME ordered channel bridged responses ride, so a
        keep-alive connection can interleave bridged and native requests
        without byte reordering. Returns close_connection."""
        if isinstance(payload, SendfileBody):
            body_bytes = None
            default_clen = str(payload.count)
            default_ctype = "application/octet-stream"
        elif isinstance(payload, AsyncStreamBody):
            body_bytes = None
            default_clen = str(payload.length)
            default_ctype = "application/octet-stream"
        elif isinstance(payload, (bytes, bytearray)):
            body_bytes = bytes(payload)
            default_clen = str(len(body_bytes))
            default_ctype = "application/octet-stream"
        else:
            body_bytes = json.dumps(payload).encode()
            default_clen = str(len(body_bytes))
            default_ctype = "application/json"
        hdr_list = [
            ("Content-Type", extra.pop("Content-Type", default_ctype)),
            ("Content-Length",
             extra.pop("Content-Length", default_clen)),
        ]
        hdr_list.extend(extra.items())
        if self.overloaded():
            hdr_list.append(("Connection", "close"))
            close = True
            SERVING.note_keepalive_shed()
        head = _native_response_head(self.handler_cls, status, hdr_list)
        try:
            if isinstance(payload, SendfileBody):
                try:
                    await flume.aput(head)
                    if head_only:
                        return close
                    op = _SendfileOp(payload.file, payload.offset,
                                     payload.count, loop=self._loop)
                    await flume.aput(op)
                    # the pump resolves the op; if the pump dies first
                    # (peer reset -> close_read drops queued items), the
                    # wait below unblocks on the pump instead of hanging
                    await asyncio.wait(
                        {op._fut, pump},
                        return_when=asyncio.FIRST_COMPLETED,
                    )
                    if not op._fut.done():
                        return True  # client gone mid-queue
                    sent = await op._fut  # already done: resolves inline
                finally:
                    # the extent fd closes on EVERY exit: completion,
                    # client death, reaper cancellation mid-sendfile
                    payload.close()
                if sent != payload.count:
                    glog.error("native sendfile produced %d of %d bytes",
                               sent, payload.count)
                    return True
                return close
            if isinstance(payload, AsyncStreamBody):
                gen = payload.chunks
                sent = 0
                try:
                    await flume.aput(head)
                    if head_only:
                        return close
                    async for piece in gen:
                        await flume.aput(piece)
                        sent += len(piece)
                except asyncio.CancelledError:
                    raise
                except ThreadFlumeClosed:
                    return True
                except Exception:
                    glog.exception(
                        "native stream reply failed after %d/%d bytes",
                        sent, payload.length)
                    return True
                finally:
                    aclose = getattr(gen, "aclose", None)
                    if aclose is not None:
                        try:
                            await aclose()
                        # sweedlint: ok broad-except generator already failed; nothing to report
                        except Exception:  # noqa: BLE001 — the generator already failed
                            pass
                if sent != payload.length:
                    glog.error("native stream produced %d of %d bytes",
                               sent, payload.length)
                    return True
                return close
            await flume.aput(head if head_only else head + body_bytes)
            return close
        except ThreadFlumeClosed:
            if isinstance(payload, SendfileBody):
                payload.close()
            return True

    async def _canned(self, flume, pump, writer, payload: bytes) -> None:
        """Loop-originated error response: let the pump finish what is
        queued first so bytes stay ordered, then write directly."""
        flume.close()
        try:
            await pump
        except Exception:
            # pump failure means the peer is gone; the canned reply is moot
            return
        try:
            writer.write(payload)
            await writer.drain()
        except (ConnectionError, OSError):
            pass
