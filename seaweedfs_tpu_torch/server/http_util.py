"""HTTP plumbing for the daemons: the route-table request handler, the two
serving cores with admission control, and the pooled keep-alive client.

The port of the JAX package's ``server/http_util.py``:

- ``JsonHandler``: routes by method and path prefix; a handler returns
  ``(status, payload)``, where bytes go out as they are, a ``StreamBody``
  piece by piece, a ``SendfileBody`` by sendfile(2), and anything else as
  JSON. ``BadRequest`` answers 400 and any other error 500. A handler tagged
  with ``mark_streaming`` reads its own body from ``rfile``. Every request
  passes the request choke point first: the tenant governor
  (``util/throttler.GOVERNOR``, off unless ``SWEED_QOS_RPS`` > 0) paces or
  sheds it with a 503, ``X-Sweed-Deadline`` sets its budget
  (``util/deadline.py``; a spent one answers 504), and it runs inside a
  server span (``stats/trace.py``) whose trace id goes back as
  ``X-Sweed-Trace-Id``.
- ``start_server``: the asyncio reactor (``server/aio.py``, the default) or,
  with ``SWEED_SERVING=threads``, a ``ThreadingHTTPServer``; either over TLS
  when given an ``ssl_context`` (the handshake runs per connection, under a
  deadline, never in the accept loop). Both shed new connections past
  ``SWEED_MAX_INFLIGHT`` (default 8192) with a canned 503 and a load-scaled
  ``Retry-After``, answer keep-alive peers with ``Connection: close`` while
  overloaded, and sever their live connections on shutdown.
- ``SERVING``: the serving-core counters behind ``/metrics`` and ``/status``.
- ``http_json`` / ``http_bytes`` / ``http_bytes_headers`` /
  ``http_stream_request`` / ``http_stream_response``: requests over
  per-thread pooled keep-alive connections (re-dialled once when a reused
  socket went stale, for idempotent methods only); ``https://`` goes through
  urllib. Every outbound request carries the active span and deadline
  (``_trace_headers``), and a serving process marks its hops internal.
- ``relay_stream``: a file-like body relayed to a handler's socket.
- ``parse_byte_range`` / ``range_headers``: single-range ``Range`` support.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from ..stats import trace as _trace
from ..util import deadline as _deadline
from ..util import glog
from ..util.locks import make_lock
from ..util.racecheck import instrument
from ..util.throttler import GOVERNOR, INTERNAL_HEADER, INTERNAL_TENANT, classify_tenant

# Set by start_server(): a process that serves cluster traffic marks its
# outbound pooled requests with X-Sweed-Internal, so intra-cluster hops
# (filer -> volume chunk fetches, heartbeats, replication) bypass the tenant
# governor. The header is trusted as far as the cluster's JWT-less internal
# auth is: a private network.
_cluster_process = False


def mark_cluster_process() -> None:
    global _cluster_process
    _cluster_process = True


def _trace_headers(headers: Optional[dict]) -> Optional[dict]:
    """Outbound headers of every internal HTTP call: the active span as
    ``X-Sweed-Trace: <trace_id>:<span_id>`` (the receiver's server span joins
    the caller's tree), the ambient deadline as ``X-Sweed-Deadline``, and in
    a serving process ``X-Sweed-Internal``. The caller's dict is never
    mutated, and headers it set explicitly win."""
    hv = _trace.inject_header()
    dv = _deadline.inject_header()
    if hv is None and dv is None and not _cluster_process:
        return headers
    out = dict(headers or {})
    if hv is not None:
        out.setdefault(_trace.TRACE_HEADER, hv)
    if dv is not None:
        out.setdefault(_deadline.DEADLINE_HEADER, dv)
    if _cluster_process:
        out.setdefault(INTERNAL_HEADER, "1")
    return out


# -- serving-core settings -----------------------------------------------------
def serving_mode() -> str:
    """``aio`` (the default: the event-loop reactor) or ``threads``
    (``SWEED_SERVING=threads``: one thread per connection)."""
    mode = os.environ.get("SWEED_SERVING", "aio").strip().lower()
    return "threads" if mode == "threads" else "aio"


def serving_watermark() -> int:
    """Inflight-connection admission watermark (0 disables shedding). Read
    per call, so it can be changed around a live server."""
    raw = os.environ.get("SWEED_MAX_INFLIGHT", "8192").strip()
    if not (raw.isascii() and raw.isdigit()):
        return 8192
    return int(raw)


def retry_after_seconds() -> int:
    """The base ``Retry-After`` of a shed 503 (``SWEED_RETRY_AFTER``)."""
    raw = os.environ.get("SWEED_RETRY_AFTER", "1").strip()
    if not (raw.isascii() and raw.isdigit()):
        return 1
    return max(1, int(raw))


def dynamic_retry_after() -> int:
    """``Retry-After`` scaled by live pressure: the base times the
    inflight/watermark load and the recent request p99, so a storm's
    retries spread out instead of coming back as one herd. Clamped to
    [base, 60]."""
    base = retry_after_seconds()
    wm = serving_watermark()
    if wm <= 0:
        return base
    load = SERVING.inflight() / wm
    val = base + int(load * (base + 2.0 * SERVING.request_p99()))
    return max(base, min(val, 60))


def sendfile_min_bytes() -> Optional[int]:
    """Data-size floor of the zero-copy GET path (``SWEED_SENDFILE_MIN``,
    default 64 KiB), or None when ``SWEED_SENDFILE=0`` disables it."""
    if os.environ.get("SWEED_SENDFILE", "1").strip() == "0":
        return None
    raw = os.environ.get("SWEED_SENDFILE_MIN", "65536").strip()
    if not (raw.isascii() and raw.isdigit()):
        return 65536
    return int(raw)


def admission_reject_response() -> bytes:
    """The canned 503 written to a just-accepted socket past the watermark."""
    return (
        "HTTP/1.1 503 Service Unavailable\r\n"
        f"Retry-After: {dynamic_retry_after()}\r\n"
        "Content-Length: 0\r\n"
        "Connection: close\r\n\r\n"
    ).encode("ascii")


@instrument
class _ServingState:
    """Process-wide serving-core counters (the ``sweed_serving_*`` gauges
    and ``/status``'s ``serving``). Live servers of either core register
    themselves; inflight is summed from them on demand."""

    def __init__(self):
        self._lock = make_lock("_ServingState._lock")
        self._servers: "weakref.WeakSet" = weakref.WeakSet()
        self._rejected = 0
        self._keepalive_shed = 0
        self._loop_lag_last_ms = 0.0
        self._loop_lag_max_ms = 0.0
        self._lat_ring: deque = deque(maxlen=256)  # recent service seconds
        self._reaped = {"idle": 0, "deadline": 0}
        self._native_hits = 0
        self._native_fallbacks = 0
        self._qos = {"ok": 0, "delay": 0, "shed": 0}
        # the filer's coalesced master assigns: rounds, fids, largest round
        self._assign_batches = 0
        self._assign_fids = 0
        self._assign_max_batch = 0

    def register_server(self, srv) -> None:
        with self._lock:
            self._servers.add(srv)

    def inflight(self) -> int:
        with self._lock:
            servers = list(self._servers)
        total = 0
        for s in servers:
            try:
                total += s.inflight_count()
            # sweedlint: ok broad-except a dying server mid-teardown must not break the gauge
            except Exception:  # noqa: BLE001 — a server mid-teardown
                pass
        return total

    def note_rejected(self) -> None:
        with self._lock:
            self._rejected += 1

    def note_keepalive_shed(self) -> None:
        with self._lock:
            self._keepalive_shed += 1

    def note_loop_lag(self, seconds: float) -> None:
        ms = max(0.0, seconds * 1000.0)
        with self._lock:
            self._loop_lag_last_ms = ms
            self._loop_lag_max_ms = max(self._loop_lag_max_ms, ms)

    def note_assign_batch(self, n: int) -> None:
        with self._lock:
            self._assign_batches += 1
            self._assign_fids += n
            self._assign_max_batch = max(self._assign_max_batch, n)

    def note_request_seconds(self, seconds: float) -> None:
        with self._lock:
            self._lat_ring.append(seconds)

    def request_p99(self) -> float:
        with self._lock:
            return self._p99_locked()

    def _p99_locked(self) -> float:
        if not self._lat_ring:
            return 0.0
        ring = sorted(self._lat_ring)
        return ring[min(len(ring) - 1, int(len(ring) * 0.99))]

    def note_reaped(self, phase: str) -> None:
        with self._lock:
            self._reaped[phase] = self._reaped.get(phase, 0) + 1

    def note_native(self) -> None:
        with self._lock:
            self._native_hits += 1

    def note_native_fallback(self) -> None:
        with self._lock:
            self._native_fallbacks += 1

    def note_qos(self, outcome: str) -> None:
        with self._lock:
            self._qos[outcome] = self._qos.get(outcome, 0) + 1

    def snapshot(self) -> dict:
        inflight = self.inflight()
        with self._lock:
            return {
                "mode": serving_mode(),
                "watermark": serving_watermark(),
                "inflight": inflight,
                "admission_rejected": self._rejected,
                "keepalive_shed": self._keepalive_shed,
                "loop_lag_ms": round(self._loop_lag_last_ms, 3),
                "loop_lag_max_ms": round(self._loop_lag_max_ms, 3),
                "assign_batches": self._assign_batches,
                "assign_fids": self._assign_fids,
                "assign_max_batch": self._assign_max_batch,
                "assign_avg_batch": round(self._assign_fids / self._assign_batches, 2)
                if self._assign_batches else 0.0,
                "request_p99_ms": round(self._p99_locked() * 1000.0, 3),
                "reaped_idle": self._reaped.get("idle", 0),
                "reaped_deadline": self._reaped.get("deadline", 0),
                "native_hits": self._native_hits,
                "native_fallbacks": self._native_fallbacks,
                "qos_ok": self._qos.get("ok", 0),
                "qos_delayed": self._qos.get("delay", 0),
                "qos_shed": self._qos.get("shed", 0),
            }


SERVING = _ServingState()


def serving_overloaded(handler) -> bool:
    """True when the handler's server is past its admission watermark."""
    fn = getattr(getattr(handler, "server", None), "overloaded", None)
    return bool(fn()) if fn is not None else False


def relay_stream(handler, payload, declared_len: Optional[int] = None) -> None:
    """Pipe a file-like body to ``handler.wfile`` in 1 MiB pieces. The
    headers are gone already, so a peer that left or an upstream that failed
    closes the payload and drops the connection: a short body and a closed
    socket are the only honest signal."""
    sent = 0
    try:
        while piece := payload.read(1 << 20):
            handler.wfile.write(piece)
            sent += len(piece)
    except (BrokenPipeError, ConnectionResetError):
        handler.close_connection = True
        return
    except Exception:  # noqa: BLE001 — the headers are gone: a short body
        glog.exception("stream relay failed after %d bytes", sent)
        handler.close_connection = True
        return
    finally:
        try:
            payload.close()
        # sweedlint: ok broad-except close of an already-failed upstream body; nothing to report
        except Exception:  # noqa: BLE001 — closing a failed upstream body
            pass
    if declared_len is not None and sent != declared_len:
        glog.error("stream relay produced %d of %d bytes", sent, declared_len)
        handler.close_connection = True


class CountedReader:
    """Bounded view of a request body stream; ``left`` counts the bytes
    not consumed yet (keep-alive framing is gone while it is non-zero)."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self.left = length

    def read(self, n: int = -1) -> bytes:
        if self.left <= 0:
            return b""
        want = self.left if n is None or n < 0 else min(n, self.left)
        got = self._rfile.read(want)
        self.left -= len(got)
        return got

    def drain(self) -> None:
        while self.left > 0 and self.read(1 << 20):
            pass


def drain_refused_body(handler, reader, cap: int = 32 << 20,
                       timeout: float = 2.0) -> None:
    """After refusing a request whose streamed body is unread: drain a
    bounded amount under a short socket timeout, so a modest body still
    gets its error reply on the keep-alive socket, while a client that
    stalls cannot wedge the worker. Anything left drops the connection."""
    old = handler.connection.gettimeout()
    handler.connection.settimeout(timeout)
    try:
        while reader.left > 0 and cap > 0:
            try:
                got = reader.read(min(1 << 20, cap))
            except OSError:  # socket.timeout included
                break
            if not got:
                break
            cap -= len(got)
    finally:
        handler.connection.settimeout(old)
    if reader.left > 0:
        handler.close_connection = True


class BadRequest(Exception):
    """Raised by a route handler on a malformed request parameter; the
    dispatcher answers 400 with the message."""


class StreamBody:
    """Handler return value for a body produced piece by piece: ``length``
    goes in Content-Length, ``chunks`` (an iterable of bytes) is written as
    it comes."""

    def __init__(self, length: int, chunks):
        self.length = length
        self.chunks = chunks


class SendfileBody:
    """Handler return value for a zero-copy reply: ``count`` bytes at
    ``offset`` of ``file`` (a real OS file, a dup of a volume's .dat fd) go
    to the socket by sendfile(2). The threads core relays with
    ``socket.sendfile``, the aio core with ``loop.sendfile``. The receiver
    always closes ``file``."""

    def __init__(self, file, offset: int, count: int):
        self.file = file
        self.offset = offset
        self.count = count

    def close(self) -> None:
        try:
            self.file.close()
        except OSError:
            pass


class AsyncStreamBody:
    """Native-route return value for a body produced piece by piece on the
    event loop (``chunks`` is an async iterable): the native StreamBody."""

    def __init__(self, length: int, chunks):
        self.length = length
        self.chunks = chunks


#: What a native route coroutine returns to hand the request to the bridged
#: worker path, which re-runs the untouched handler class: native routes
#: serve only the plain hot path, every edge falls back.
NATIVE_FALLBACK = object()


def request_tenant(headers, remote_addr: str) -> str:
    """The tenant key of a request, from any case-insensitive headers
    mapping (an http.client message or the native path's view)."""
    return classify_tenant(lambda k, d="": (headers.get(k) or d), remote_addr)


def observe_tenant_request(tenant: str, seconds: float) -> None:
    """A request's service time under its tenant, for ``/metrics``. Kept
    when the tenant is explicit (header or access key) or the governor is
    on: anonymous /24 classes are labelled only while QoS is active, which
    bounds the labels' cardinality."""
    if tenant == INTERNAL_TENANT:
        return
    if not (GOVERNOR.enabled() or not tenant.startswith("ip:")):
        return
    from ..stats import metrics as _metrics  # stats imports this module

    _metrics.note_qos_request(tenant, seconds)


def count_qos_decision(tenant: str, outcome: str) -> None:
    """The governor's shed / delay / ok counters, per tenant."""
    SERVING.note_qos(outcome)
    from ..stats import metrics as _metrics

    _metrics.note_qos_decision(tenant, outcome)


def has_dot_segments(path: str) -> bool:
    """True when any "/"-separated segment is literally "." or "..". The
    filer stores segments literally (no traversal), but a stored ".." entry
    is unrepresentable through a FUSE mount and poisons POSIX listings, so
    the filer refuses such writes."""
    return any(seg in (".", "..") for seg in path.split("/"))


def parse_content_length(headers) -> int:
    """Content-Length as a non-negative int, or -1 when it is garbage (a
    naive ``int`` of '-5' would make ``rfile.read`` block)."""
    raw = (headers.get("Content-Length") or "0").strip()
    if not (raw.isascii() and raw.isdigit()):
        return -1
    return int(raw)


class JsonHandler(BaseHTTPRequestHandler):
    """Route-table handler; subclasses set ``routes`` as
    ``[(method, path_prefix, fn)]`` with ``fn(handler, path, query, body) ->
    (status, payload)``. A handler may set ``extra_headers`` for its reply.
    ``native_routes`` (``[(method, prefix, coroutine)]``) are served on the
    aio reactor's loop; the threads core ignores them."""

    # headers and body go out as separate writes: without TCP_NODELAY a
    # keep-alive peer's delayed ACK adds ~40 ms to every reply
    disable_nagle_algorithm = True
    protocol_version = "HTTP/1.1"
    routes: list[tuple[str, str, Callable]] = []
    native_routes: list[tuple[str, str, Callable]] = []
    server_ctx: Any = None
    extra_headers: Optional[dict] = None
    # the service tag of this daemon's server spans ("master", "volume",
    # "filer", "s3"); subclasses override
    trace_service: str = "http"

    def log_message(self, fmt, *args):  # stdlib access log -> V(3)
        glog.V(3).info("http: " + fmt, *args)

    @staticmethod
    def mark_streaming(fn):
        """Tag a route handler as streaming: it is called as
        ``fn(h, path, query, rfile, length)`` before the body is read, and
        must consume exactly ``length`` bytes of ``rfile``."""
        fn._streaming = True
        return fn

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        length = parse_content_length(self.headers)
        if length < 0:
            # the body's framing is unknowable: answer and drop the connection
            self.close_connection = True
            self._reply(400, {"error": "bad Content-Length"})
            return
        # the tenant governor: a tenant past its weighted-fair share is paced
        # on this worker, then shed with 503 + Retry-After; internal hops
        # bypass. The connection stays open on a shed: a forced close makes
        # the abuser reconnect, which costs the server more than the abuser.
        tenant = request_tenant(self.headers, self.client_address[0])
        decision, wait = GOVERNOR.admit(tenant)
        if decision == "shed":
            count_qos_decision(tenant, "shed")
            self.extra_headers = dict(self.extra_headers or {})
            self.extra_headers["Retry-After"] = str(dynamic_retry_after())
            self._reply(503, {"error": "tenant over rate"})
            return
        if decision == "delay":
            count_qos_decision(tenant, "delay")
            time.sleep(wait)
        elif GOVERNOR.enabled() and tenant != INTERNAL_TENANT:
            count_qos_decision(tenant, "ok")
        t0 = time.monotonic()
        # the ambient deadline, entered around the handler so that every hop
        # it makes inherits the budget; the aio reactor bridges through this
        # same dispatch
        ddl = (_deadline.parse_header(self.headers.get(_deadline.DEADLINE_HEADER))
               if _deadline.enabled() else None)
        body = None  # read lazily: streaming handlers consume rfile themselves
        for m, prefix, fn in self.routes:
            if m == method and parsed.path.startswith(prefix):
                streaming = getattr(fn, "_streaming", False)
                # the server span, named by the route prefix (bounded names;
                # the path rides in a tag); the reply happens inside it, so a
                # streamed body counts toward the hop's time
                with _trace.start_span(f"{method} {prefix}", service=self.trace_service,
                                       parent_header=self.headers.get(_trace.TRACE_HEADER),
                                       path=parsed.path) as span:
                    cancelled = False
                    try:
                        with _deadline.scope(ddl):
                            if ddl is not None and _deadline.expired():
                                # the budget died upstream: answer 504
                                # without doing the work
                                _deadline.note("expired_inbound")
                                cancelled = True
                                raise _deadline.DeadlineExceeded(-(_deadline.remaining() or 0.0))
                            if streaming:
                                status, payload = fn(self, parsed.path, query, self.rfile, length)
                            else:
                                body = self.rfile.read(length) if length else b""
                                status, payload = fn(self, parsed.path, query, body)
                    except _deadline.DeadlineExceeded as e:
                        if not cancelled:
                            _deadline.note("aborted_handler")
                        cancelled = True
                        status, payload = 504, {"error": f"deadline exceeded: {e}"}
                        if streaming or (body is None and length):
                            self.close_connection = True  # the body is unread
                    except BadRequest as e:
                        status, payload = 400, {"error": str(e)}
                        if streaming:  # the body may be half read: framing is gone
                            self.close_connection = True
                    except Exception as e:  # noqa: BLE001 — the daemon keeps serving
                        glog.exception("%s %s failed", method, parsed.path)
                        status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                        if streaming:
                            self.close_connection = True
                    if span is not None:
                        span.tags["status"] = status
                        if cancelled:  # the tree shows where the budget died
                            span.status = "cancelled"
                            span.tags["deadline"] = "exceeded"
                        elif status >= 500:
                            span.status = "error"
                        self.extra_headers = dict(self.extra_headers or {})
                        self.extra_headers.setdefault(_trace.TRACE_ID_HEADER, span.trace_id)
                    glog.V(2).info("%s %s -> %d", method, parsed.path, status)
                    self._reply(status, payload, head_only=(method == "HEAD"))
                    dt = time.monotonic() - t0
                    SERVING.note_request_seconds(dt)
                    observe_tenant_request(tenant, dt)
                return
        # drain in bounded pieces for keep-alive framing: a large body to an
        # unrouted path must not be buffered whole
        left = length
        while left > 0:
            got = self.rfile.read(min(1 << 20, left))
            if not got:
                break
            left -= len(got)
        self._reply(404, {"error": f"no route {method} {parsed.path}"})

    def _shed_keepalive_if_overloaded(self) -> None:
        """Past the watermark, tell a keep-alive peer to go away after this
        reply, so established pools drain back through admission."""
        if serving_overloaded(self):
            self.send_header("Connection", "close")
            self.close_connection = True
            SERVING.note_keepalive_shed()

    def _send_head(self, status: int, ctype: str, clen: str) -> None:
        extra = self.extra_headers or {}
        self.extra_headers = None
        ctype = extra.pop("Content-Type", ctype)
        # a HEAD of a chunked file advertises the whole file's length
        clen = extra.pop("Content-Length", clen)
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", clen)
        for k, v in extra.items():
            self.send_header(k, v)
        self._shed_keepalive_if_overloaded()
        self.end_headers()

    def _reply(self, status: int, payload, head_only: bool = False) -> None:
        if isinstance(payload, StreamBody):
            self._reply_stream(status, payload, head_only)
            return
        if isinstance(payload, SendfileBody):
            self._reply_sendfile(status, payload, head_only)
            return
        if isinstance(payload, (bytes, bytearray, memoryview)):
            data = bytes(payload)
            ctype = "application/octet-stream"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        self._send_head(status, ctype, str(len(data)))
        if head_only:
            return
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def _reply_sendfile(self, status: int, body: SendfileBody, head_only: bool) -> None:
        """Zero-copy reply: the headers through the normal path, then the
        needle's data region kernel → socket. The aio reactor's shim
        connection offers the same ``connection.sendfile`` surface, so this
        serves both cores."""
        self._send_head(status, "application/octet-stream", str(body.count))
        if head_only:
            body.close()
            return
        sent = 0
        try:
            self.wfile.flush()  # headers first: sendfile bypasses wfile
            sent = self.connection.sendfile(body.file, offset=body.offset,
                                            count=body.count) or 0
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return
        except Exception:  # noqa: BLE001 — the headers are gone: a short body
            glog.exception("sendfile reply failed after %d/%d bytes", sent, body.count)
            self.close_connection = True
            return
        finally:
            body.close()
        if sent != body.count:
            glog.error("sendfile reply produced %d of %d bytes", sent, body.count)
            self.close_connection = True

    def _reply_stream(self, status: int, body: StreamBody, head_only: bool) -> None:
        """A reply whose bytes come piece by piece: Content-Length up front,
        each piece written as it is produced."""
        self._send_head(status, "application/octet-stream", str(body.length))
        if head_only:
            return
        sent = 0
        try:
            for piece in body.chunks:
                self.wfile.write(piece)
                sent += len(piece)
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True
            return
        except Exception:  # noqa: BLE001 — the headers are gone: a short body
            glog.exception("stream reply failed after %d/%d bytes", sent, body.length)
            self.close_connection = True
            return
        if sent != body.length:
            glog.error("stream reply produced %d of %d bytes", sent, body.length)
            self.close_connection = True

    def do_GET(self):
        self._dispatch("GET")

    def do_HEAD(self):
        self._dispatch("HEAD")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")


def _close_socket(sock) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _TrackingThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with admission at the inflight watermark, that
    severs its live keep-alive connections on shutdown (otherwise their
    handler threads go on answering after the server stopped)."""

    daemon_threads = True
    # the default backlog of 5 drops SYNs under a burst of new connections
    request_queue_size = 2048

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._live_conns: set = set()
        self._conns_lock = threading.Lock()
        self._shutting_down = False
        SERVING.register_server(self)

    def inflight_count(self) -> int:
        with self._conns_lock:
            return len(self._live_conns)

    def overloaded(self) -> bool:
        wm = serving_watermark()
        return wm > 0 and self.inflight_count() >= wm

    def process_request(self, request, client_address):
        wm = serving_watermark()
        with self._conns_lock:
            if self._shutting_down:
                # raced shutdown(): the sever pass may have run already
                _close_socket(request)
                return
            reject = wm > 0 and len(self._live_conns) >= wm
            if not reject:
                self._live_conns.add(request)
        if reject:
            SERVING.note_rejected()
            try:
                request.sendall(admission_reject_response())
            except OSError:
                pass
            _close_socket(request)
            return
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._live_conns.discard(request)
        super().shutdown_request(request)

    def shutdown(self):
        super().shutdown()
        with self._conns_lock:
            self._shutting_down = True
            conns = list(self._live_conns)
            self._live_conns.clear()
        for c in conns:
            _close_socket(c)


class _TlsThreadingHTTPServer(_TrackingThreadingHTTPServer):
    """The threads core over TLS. The handshake runs in the connection's
    worker thread under a 10 s deadline: wrapping the listening socket
    would run handshakes in the one accept loop, where a client that never
    speaks TLS freezes the whole server."""

    def __init__(self, addr, handler_cls, ssl_context):
        self._ssl_context = ssl_context
        super().__init__(addr, handler_cls)

    def finish_request(self, request, client_address):
        try:
            request.settimeout(10)
            tls_conn = self._ssl_context.wrap_socket(request, server_side=True)
            tls_conn.settimeout(None)
        except (ssl.SSLError, OSError):
            _close_socket(request)
            return
        # wrap_socket detached the raw socket process_request tracked: track
        # the TLS socket instead, or shutdown() severs a dead fd
        with self._conns_lock:
            if self._shutting_down:  # the sever pass already ran
                _close_socket(tls_conn)
                return
            self._live_conns.discard(request)
            self._live_conns.add(tls_conn)
        try:
            self.RequestHandlerClass(tls_conn, client_address, self)
        finally:
            with self._conns_lock:
                self._live_conns.discard(tls_conn)
            try:
                tls_conn.close()
            except OSError:
                pass


def start_server(handler_cls, host: str, port: int, ssl_context=None):
    """Serve ``handler_cls`` on (host, port) from a background thread: the
    asyncio reactor by default, the thread-per-connection server under
    ``SWEED_SERVING=threads``; over TLS when ``ssl_context`` is given. Both
    offer ``shutdown()``, ``server_close()`` and ``server_address``, and
    admission control. The process is marked as serving cluster traffic, so
    its outbound hops are internal (``_trace_headers``)."""
    mark_cluster_process()
    if serving_mode() == "aio":
        from .aio import AioHTTPServer

        return AioHTTPServer(handler_cls, host, port, ssl_context=ssl_context).start()
    if ssl_context is None:
        srv = _TrackingThreadingHTTPServer((host, port), handler_cls)
    else:
        srv = _TlsThreadingHTTPServer((host, port), handler_cls, ssl_context)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"http-{host}:{srv.server_address[1]}").start()
    return srv


# -- pooled keep-alive client --------------------------------------------------
# A fresh TCP connection per request costs a handshake on the hottest paths
# (assigns, heartbeats, remote shard reads, replication). Connections are
# pooled per (host, port) in thread-local storage (http.client connections
# are not thread-safe) and re-dialled once when a pooled socket went stale.
_pool_local = threading.local()


def pool_max_idle_seconds() -> float:
    """Max idle age of a pooled socket (``SWEED_POOL_IDLE_S``, default 30;
    0 keeps them forever): old sockets retire before a peer's keep-alive
    timeout can race a reuse."""
    raw = os.environ.get("SWEED_POOL_IDLE_S", "30").strip()
    if not (raw.isascii() and raw.isdigit()):
        return 30.0
    return float(int(raw))


def _conn_idle_expired(conn) -> bool:
    max_idle = pool_max_idle_seconds()
    if max_idle <= 0:
        return False
    since = getattr(conn, "_sweed_idle_since", None)
    return since is not None and (time.monotonic() - since) > max_idle


class _NoDelayHTTPConnection(http.client.HTTPConnection):
    def connect(self):
        super().connect()
        # Nagle and a delayed ACK turn each small request on a reused
        # connection into a ~40 ms round trip
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE"})


def _pool() -> dict:
    conns = getattr(_pool_local, "conns", None)
    if conns is None:
        conns = _pool_local.conns = {}
    return conns


def _pooled_request(method: str, url: str, body: Optional[bytes],
                    headers: Optional[dict], timeout: float,
                    idempotent: bool = False) -> tuple[int, bytes, dict]:
    u = urllib.parse.urlsplit(url)
    key = (u.hostname, u.port)
    conns = _pool()
    path = u.path + (f"?{u.query}" if u.query else "")
    # a stale-socket retry can run a request twice (a reset may come after
    # the server executed it), so only idempotent methods, and POSTs the
    # caller marks idempotent (a fid-addressed upload), are retried
    may_retry = method in _IDEMPOTENT_METHODS or idempotent
    last_err: Optional[Exception] = None
    for attempt in (0, 1):
        conn = conns.get(key)
        if conn is not None and _conn_idle_expired(conn):
            conn.close()
            conns.pop(key, None)
            conn = None
        fresh = conn is None
        if fresh:
            conn = _NoDelayHTTPConnection(u.hostname, u.port, timeout=timeout)
            conns[key] = conn
        elif conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            resp_headers = dict(resp.getheaders())
            if resp.will_close:
                conn.close()
                conns.pop(key, None)
            else:
                # sweedlint: ok cross-domain-race thread-local pool (_pool_local): a pooled connection is only used by the thread that made it
                conn._sweed_idle_since = time.monotonic()
            return resp.status, data, resp_headers
        except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                ConnectionResetError, BrokenPipeError) as e:
            # the peer closed a reused socket before answering: re-dial once
            conn.close()
            conns.pop(key, None)
            last_err = e
            if fresh or attempt or not may_retry:
                raise
        except (http.client.HTTPException, OSError):
            conn.close()
            conns.pop(key, None)
            raise
    raise last_err  # unreachable


def _conn_is_stale(conn) -> bool:
    """True when a pooled socket's peer closed it (readable with EOF
    pending); a healthy idle HTTP/1.1 socket has nothing to read."""
    sock = getattr(conn, "sock", None)
    if sock is None:
        return False
    import select

    try:
        readable, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True
    return bool(readable)


def _checkout_conn(key: tuple, timeout: float):
    """The calling thread's pooled connection for (host, port), probed for
    staleness, or a fresh one; removed from the pool until ``_repool``."""
    conns = _pool()
    conn = conns.pop(key, None)
    if conn is not None and (_conn_idle_expired(conn) or _conn_is_stale(conn)):
        conn.close()
        conn = None
    if conn is None:
        conn = _NoDelayHTTPConnection(key[0], key[1], timeout=timeout)
    elif conn.sock is not None:
        conn.sock.settimeout(timeout)
    return conn, conns


def _repool(conn, key: tuple, conns: dict) -> None:
    if key in conns:  # another request pooled its own meanwhile
        conn.close()
    else:
        conn._sweed_idle_since = time.monotonic()
        conns[key] = conn


def http_stream_request(method: str, url: str, reader, length: int,
                        headers: Optional[dict] = None,
                        timeout: float = 600.0) -> tuple[int, bytes, dict]:
    """A request whose body streams from a file-like ``reader`` over the
    pooled transport. A consumed reader cannot be rewound, so there is no
    stale-socket retry; the pooled socket is probed before the first byte."""
    timeout = _deadline.clamp_timeout(timeout)
    hdrs = dict(_trace_headers(headers) or {})
    hdrs.setdefault("Content-Length", str(length))
    if not url.startswith("http://"):
        return _urllib_request(method, url, reader, hdrs, timeout)
    u = urllib.parse.urlsplit(url)
    key = (u.hostname, u.port)
    path = u.path + (f"?{u.query}" if u.query else "")
    conn, conns = _checkout_conn(key, timeout)
    try:
        conn.blocksize = 1 << 20  # MB pieces, not 8 KB sips
        conn.request(method, path, body=reader, headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        resp_headers = dict(resp.getheaders())
        if resp.will_close:
            conn.close()
        else:
            _repool(conn, key, conns)
        return resp.status, data, resp_headers
    except Exception:
        conn.close()
        raise


def _urllib_request(method: str, url: str, body, headers: dict,
                    timeout: float) -> tuple[int, bytes, dict]:
    """An ``https://`` request through urllib, with its default TLS context."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class _PooledStreamBody:
    """File-like over a pooled connection's reply body, whose bytes stay on
    the wire until read. Reading to EOF hands the socket back to the calling
    thread's pool; closing with bytes unread (or a read error) drops it."""

    def __init__(self, resp, conn, key, conns):
        self._resp, self._conn = resp, conn
        self._key, self._conns = key, conns
        self._owner = threading.get_ident()
        self._done = False

    def read(self, n: int = -1) -> bytes:
        try:
            data = self._resp.read(n)
        except Exception:
            self._discard()
            raise
        if self._resp.isclosed():
            self._settle()
        return data

    def _settle(self) -> None:
        if self._done:
            return
        self._done = True
        if self._resp.will_close or threading.get_ident() != self._owner:
            # conns is the creating thread's pool: repooling from another
            # thread would share one http.client connection across threads
            self._conn.close()
        else:
            _repool(self._conn, self._key, self._conns)

    def _discard(self) -> None:
        if not self._done:
            self._done = True
            self._conn.close()

    def close(self) -> None:
        if self._resp.isclosed():
            self._settle()
        else:
            self._discard()
        try:
            self._resp.close()
        # sweedlint: ok broad-except socket already torn down; nothing to report
        except Exception:  # noqa: BLE001 — the socket is torn down already
            pass


def http_stream_response(method: str, url: str, headers: Optional[dict] = None,
                         timeout: float = 600.0) -> tuple[int, object, dict]:
    """A request whose reply body stays on the wire: (status, file-like
    body, headers) for a success status (the caller reads it piecewise and
    must ``close()`` it), or (status, the error bytes, headers) for >= 400.
    The pooled connection is checked out until the body is read, so a nested
    request to the same peer on this thread dials its own socket."""
    timeout = _deadline.clamp_timeout(timeout)
    headers = _trace_headers(headers)
    if not url.startswith("http://"):
        req = urllib.request.Request(url, method=method, headers=headers or {})
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
            return resp.status, resp, dict(resp.headers)
        except urllib.error.HTTPError as e:
            body = e.read()
            e.close()
            return e.code, body, dict(e.headers)
    u = urllib.parse.urlsplit(url)
    key = (u.hostname, u.port)
    path = u.path + (f"?{u.query}" if u.query else "")
    may_retry = method in _IDEMPOTENT_METHODS
    last_err: Optional[Exception] = None
    for attempt in (0, 1):
        conn, conns = _checkout_conn(key, timeout)
        fresh = conn.sock is None
        try:
            conn.request(method, path, headers=headers or {})
            resp = conn.getresponse()
        except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                ConnectionResetError, BrokenPipeError) as e:
            # the peer closed a reused socket before answering: re-dial once
            conn.close()
            last_err = e
            if fresh or attempt == 1 or not may_retry:
                raise
            continue
        except Exception:
            conn.close()
            raise
        hdrs = dict(resp.getheaders())
        if resp.status >= 400:
            try:
                data = resp.read()
            except Exception:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                _repool(conn, key, conns)
            return resp.status, data, hdrs
        return resp.status, _PooledStreamBody(resp, conn, key, conns), hdrs
    raise last_err  # unreachable


def http_bytes_headers(method: str, url: str, body: Optional[bytes] = None,
                       timeout: float = 30.0, headers: Optional[dict] = None,
                       idempotent: bool = False) -> tuple[int, bytes, dict]:
    """One request over the pooled transport -> (status, body, reply
    headers). An unreachable peer raises OSError; HTTP error statuses come
    back as statuses. ``idempotent`` lets a POST take the stale-socket
    retry (fid-addressed uploads are safe to resend; assigns are not). The
    timeout is clamped to the ambient deadline, and a spent one raises
    ``DeadlineExceeded`` before anything goes on the wire."""
    timeout = _deadline.clamp_timeout(timeout)
    headers = _trace_headers(headers)
    if not url.startswith("http://"):
        return _urllib_request(method, url, body, headers or {}, timeout)
    return _pooled_request(method, url, body, headers, timeout, idempotent=idempotent)


def http_bytes(method: str, url: str, body: Optional[bytes] = None,
               timeout: float = 30.0, headers: Optional[dict] = None,
               idempotent: bool = False) -> tuple[int, bytes]:
    """One request over the pooled transport -> (status, body)."""
    status, data, _ = http_bytes_headers(method, url, body, timeout, headers, idempotent)
    return status, data


def http_json(method: str, url: str, body: "dict | bytes | None" = None,
              timeout: float = 30.0) -> dict:
    """Request with a JSON (or raw) body, JSON reply. An unreachable peer
    raises; an HTTP error status comes back as the reply's dict with
    ``_status`` set."""
    headers = {}
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    status, payload = http_bytes(method, url, body=body, timeout=timeout,
                                 headers=headers)
    if status >= 400:
        try:
            return json.loads(payload or b"{}") | {"_status": status}
        except json.JSONDecodeError:
            return {"error": payload[:200].decode("utf-8", "replace"),
                    "_status": status}
    return json.loads(payload or b"{}")


def parse_byte_range(rng: str, total: int):
    """Single range 'bytes=a-b' -> (start, end) inclusive; None = serve the
    whole body (absent, malformed or multi-range); 'unsatisfiable' = 416."""
    spec = rng.strip()
    if not spec.startswith("bytes=") or "," in spec:
        return None
    start_s, _, end_s = spec[len("bytes="):].partition("-")
    try:
        if start_s == "":  # suffix form: the last N bytes
            start, end = max(0, total - int(end_s)), total - 1
        else:
            start = int(start_s)
            end = int(end_s) if end_s else total - 1
    except ValueError:
        return None
    end = min(end, total - 1)
    if start > end or start >= total:
        return "unsatisfiable"
    return start, end


def range_headers(start: int, end: int, total: int) -> dict:
    return {"Content-Range": f"bytes {start}-{end}/{total}",
            "Accept-Ranges": "bytes"}


def unsatisfiable_range_headers(total: int) -> dict:
    return {"Content-Range": f"bytes */{total}"}
