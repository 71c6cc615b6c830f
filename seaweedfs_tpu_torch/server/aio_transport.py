"""Async pooled keep-alive HTTP transport for native-async handlers.

The port's copy of the JAX package's ``server/aio_transport.py``: the
filer's native GET (``filer_server._h_read_native``) and the S3 gateway's
(``s3api_server._get_object_native``) run ON the asyncio reactor's loop
(``server/aio.py``), where a sync ``http.client`` call would stall every
parked connection, so their upstream requests ride this asyncio mirror of
``http_util``'s pooled transport:

- connections pooled per (host, port), keep-alive, TCP_NODELAY;
- checkout probes for staleness (peer FIN pending) and idle age
  (``pool_max_idle_seconds``);
- a one-shot re-dial retry only for idempotent methods, only when a
  reused socket dies before the first response byte (the idle-close
  race), as ``_pooled_request`` does;
- outbound headers carry the ambient trace and deadline and
  ``X-Sweed-Internal`` (``_outbound_headers``: this transport runs only
  inside daemons, so every request is an intra-cluster hop);
- ``request`` reads the whole reply, ``stream`` leaves its body on the wire
  (``AStreamBody``).

Only ``http://`` is supported. Pools are keyed by the running loop
(WeakKeyDictionary): a process can host several reactors (volume servers
and a filer in one process) without sharing sockets across loops.
"""

from __future__ import annotations

import asyncio
import time
import urllib.parse
import weakref
from typing import Optional

from ..stats import trace as _trace
from ..util import deadline as _deadline
from ..util.throttler import INTERNAL_HEADER
from .http_util import _IDEMPOTENT_METHODS, pool_max_idle_seconds

#: max pooled sockets per (host, port) per loop; excess closes on repool
POOL_MAX_PER_KEY = 32

_pools: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _AConn:
    __slots__ = ("reader", "writer", "idle_since")

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.idle_since = time.monotonic()

    def stale(self) -> bool:
        if self.reader.at_eof() or self.writer.is_closing():
            return True
        max_idle = pool_max_idle_seconds()
        return max_idle > 0 and (
            time.monotonic() - self.idle_since
        ) > max_idle

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001 — the transport may already be gone
            pass


def _pool() -> dict:
    loop = asyncio.get_running_loop()
    p = _pools.get(loop)
    if p is None:
        p = _pools[loop] = {}
    return p


def _checkout(key: tuple) -> Optional[_AConn]:
    conns = _pool().get(key)
    while conns:
        conn = conns.pop()
        if conn.stale():
            conn.close()
            continue
        return conn
    return None


def _repool(key: tuple, conn: _AConn) -> None:
    conns = _pool().setdefault(key, [])
    if len(conns) >= POOL_MAX_PER_KEY:
        conn.close()
        return
    conn.idle_since = time.monotonic()
    conns.append(conn)


async def _dial(key: tuple, timeout: float) -> _AConn:
    import socket as _socket

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(key[0], key[1], limit=1 << 20),
        timeout=timeout,
    )
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass
    return _AConn(reader, writer)


def _build_head(method: str, u, headers: dict, body_len: int) -> bytes:
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    host = u.hostname if u.port is None else f"{u.hostname}:{u.port}"
    lines = [f"{method} {path} HTTP/1.1", f"Host: {host}"]
    sent = {k.lower() for k in headers}
    if "content-length" not in sent and (body_len or method in
                                         ("POST", "PUT")):
        lines.append(f"Content-Length: {body_len}")
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _read_response(conn: _AConn, timeout: float):
    """Parse status line + headers off the wire. Returns
    (status, headers dict lower-cased, will_close, content_length)."""
    head = await asyncio.wait_for(
        conn.reader.readuntil(b"\r\n\r\n"), timeout=timeout
    )
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ConnectionError(f"bad status line {lines[0]!r}")
    version, status = parts[0], int(parts[1])
    hdrs: dict = {}
    for line in lines[1:]:
        if not line:
            continue
        k, _, v = line.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    will_close = (
        version == "HTTP/1.0"
        or hdrs.get("connection", "").lower() == "close"
    )
    clen_raw = hdrs.get("content-length", "")
    clen = int(clen_raw) if clen_raw.isdigit() else None
    if clen is None:
        will_close = True  # unframed body: read to EOF, can't reuse
    return status, hdrs, will_close, clen


def _outbound_headers(headers: Optional[dict]) -> dict:
    """The trace, deadline and internal-hop headers, as
    ``http_util._trace_headers`` adds them (the caller's headers win)."""
    out = dict(headers or {})
    hv = _trace.inject_header()
    if hv is not None:
        out.setdefault(_trace.TRACE_HEADER, hv)
    dv = _deadline.inject_header()
    if dv is not None:
        out.setdefault(_deadline.DEADLINE_HEADER, dv)
    out.setdefault(INTERNAL_HEADER, "1")
    return out


async def request(
    method: str,
    url: str,
    body: Optional[bytes] = None,
    headers: Optional[dict] = None,
    timeout: float = 30.0,
) -> tuple[int, bytes, dict]:
    """Full-body request over the loop's pool → (status, bytes, headers).
    http:// only — callers gate on the scheme and fall back otherwise."""
    timeout = _deadline.clamp_timeout(timeout)
    u = urllib.parse.urlsplit(url)
    key = (u.hostname, u.port)
    hdrs = _outbound_headers(headers)
    payload = body or b""
    head = _build_head(method, u, hdrs, len(payload))
    may_retry = method in _IDEMPOTENT_METHODS
    for attempt in (0, 1):
        conn = _checkout(key)
        fresh = conn is None
        if fresh:
            conn = await _dial(key, timeout)
        try:
            conn.writer.write(head + payload)
            await asyncio.wait_for(conn.writer.drain(), timeout=timeout)
            status, rhdrs, will_close, clen = await _read_response(
                conn, timeout
            )
            if clen is not None:
                data = await asyncio.wait_for(
                    conn.reader.readexactly(clen), timeout=timeout
                )
            else:
                data = await asyncio.wait_for(
                    conn.reader.read(-1), timeout=timeout
                )
            if will_close:
                conn.close()
            else:
                _repool(key, conn)
            return status, data, dict(rhdrs)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            # idle-close race on a reused socket: safe to re-dial once
            # for idempotent methods (same discipline as _pooled_request)
            conn.close()
            if fresh or attempt or not may_retry:
                raise
        except BaseException:
            conn.close()  # timeouts / cancellation: framing unknowable
            raise
    raise ConnectionError("unreachable")  # keeps type checkers honest


class AStreamBody:
    """Async file-like over an in-flight pooled response body: bytes stay
    on the wire until awaited. Reading to the declared length repools the
    socket; closing early discards it (framing unusable mid-body)."""

    def __init__(self, conn: _AConn, key: tuple, length: Optional[int],
                 will_close: bool, timeout: float):
        self._conn = conn
        self._key = key
        self.length = length
        self._left = length
        self._will_close = will_close
        self._timeout = timeout
        self._done = False

    async def read(self, n: int = -1) -> bytes:
        if self._done:
            return b""
        want = n
        if self._left is not None:
            want = self._left if n is None or n < 0 else min(n, self._left)
            if want <= 0:
                self._settle()
                return b""
        try:
            data = await asyncio.wait_for(
                self._conn.reader.read(want if want and want > 0 else
                                       (1 << 20)),
                timeout=self._timeout,
            )
        except BaseException:
            self._discard()
            raise
        if self._left is not None:
            self._left -= len(data)
            if self._left <= 0:
                self._settle()
            elif not data:
                # peer died mid-body: surface the truncation
                self._discard()
                raise ConnectionError(
                    f"response body truncated ({self._left} bytes short)"
                )
        elif not data:
            self._settle()
        return data

    def _settle(self) -> None:
        if self._done:
            return
        self._done = True
        if self._will_close:
            self._conn.close()
        else:
            _repool(self._key, self._conn)

    def _discard(self) -> None:
        if not self._done:
            self._done = True
            self._conn.close()

    def close(self) -> None:
        if self._left is not None and self._left <= 0:
            self._settle()
        else:
            self._discard()


async def stream(
    method: str,
    url: str,
    headers: Optional[dict] = None,
    timeout: float = 600.0,
) -> tuple[int, object, dict]:
    """A request whose reply body stays on the wire: (status, AStreamBody,
    headers) on success, (status, the error bytes, headers) for >= 400; the
    async mirror of ``http_util.http_stream_response``."""
    timeout = _deadline.clamp_timeout(timeout)
    u = urllib.parse.urlsplit(url)
    key = (u.hostname, u.port)
    hdrs = _outbound_headers(headers)
    head = _build_head(method, u, hdrs, 0)
    may_retry = method in _IDEMPOTENT_METHODS
    for attempt in (0, 1):
        conn = _checkout(key)
        fresh = conn is None
        if fresh:
            conn = await _dial(key, timeout)
        try:
            conn.writer.write(head)
            await asyncio.wait_for(conn.writer.drain(), timeout=timeout)
            status, rhdrs, will_close, clen = await _read_response(
                conn, timeout
            )
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            conn.close()
            if fresh or attempt or not may_retry:
                raise
            continue
        except BaseException:
            conn.close()
            raise
        if status >= 400:
            try:
                if clen is not None:
                    data = await asyncio.wait_for(
                        conn.reader.readexactly(clen), timeout=timeout
                    )
                else:
                    data = await asyncio.wait_for(
                        conn.reader.read(-1), timeout=timeout
                    )
            except BaseException:
                conn.close()
                raise
            if will_close:
                conn.close()
            else:
                _repool(key, conn)
            return status, data, dict(rhdrs)
        return status, AStreamBody(conn, key, clen, will_close,
                                   timeout), dict(rhdrs)
    raise ConnectionError("unreachable")  # keeps type checkers honest


def pool_stats() -> dict:
    """Idle-socket counts per loop, for tests and /_status debugging."""
    out = {}
    for loop, pool in list(_pools.items()):
        out[id(loop)] = {
            f"{k[0]}:{k[1]}": len(v) for k, v in pool.items()
        }
    return out
