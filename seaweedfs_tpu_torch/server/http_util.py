"""HTTP plumbing for the daemons: a route-table request handler, a threaded
server, and small client calls.

The subset of the JAX package's ``server/http_util.py`` that the volume
server needs:

- ``JsonHandler``: routes by method and path prefix; a handler returns
  ``(status, payload)``, where bytes go out as they are and anything else as
  JSON. ``BadRequest`` answers 400 and any other error 500.
- ``start_server``: a ``ThreadingHTTPServer`` (one thread per connection)
  that severs its live keep-alive connections on shutdown.
- ``http_json`` / ``http_bytes``: one request each on a fresh connection.
- ``parse_byte_range`` / ``range_headers``: single-range ``Range`` support.

Not ported: admission and QoS, tracing, deadlines, sendfile replies, the
asyncio serving core, TLS and the pooled keep-alive client.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..util import glog


class BadRequest(Exception):
    """Raised by a route handler on a malformed request parameter; the
    dispatcher answers 400 with the message."""


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
    (status, payload)``. A handler may set ``extra_headers`` for its reply."""

    # headers and body go out as separate writes: without TCP_NODELAY a
    # keep-alive peer's delayed ACK adds ~40 ms to every reply
    disable_nagle_algorithm = True
    protocol_version = "HTTP/1.1"
    routes: list[tuple[str, str, Callable]] = []
    extra_headers: Optional[dict] = None

    def log_message(self, fmt, *args):  # stdlib access log -> V(3)
        glog.V(3).info("http: " + fmt, *args)

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        length = parse_content_length(self.headers)
        if length < 0:
            # the body's framing is unknowable: answer and drop the connection
            self.close_connection = True
            self._reply(400, {"error": "bad Content-Length"})
            return
        body = self.rfile.read(length) if length else b""
        for m, prefix, fn in self.routes:
            if m == method and parsed.path.startswith(prefix):
                try:
                    status, payload = fn(self, parsed.path, query, body)
                except BadRequest as e:
                    status, payload = 400, {"error": str(e)}
                except Exception as e:  # noqa: BLE001 — the daemon keeps serving
                    glog.exception("%s %s failed", method, parsed.path)
                    status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
                glog.V(2).info("%s %s -> %d", method, parsed.path, status)
                self._reply(status, payload, head_only=(method == "HEAD"))
                return
        self._reply(404, {"error": f"no route {method} {parsed.path}"})

    def _reply(self, status: int, payload, head_only: bool = False) -> None:
        if isinstance(payload, (bytes, bytearray, memoryview)):
            data = bytes(payload)
            ctype = "application/octet-stream"
        else:
            data = json.dumps(payload).encode()
            ctype = "application/json"
        extra = self.extra_headers or {}
        self.extra_headers = None
        ctype = extra.pop("Content-Type", ctype)
        # a HEAD of a chunked file advertises the whole file's length
        clen = extra.pop("Content-Length", str(len(data)))
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", clen)
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        if head_only:
            return
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
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


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer that closes its live connections on shutdown:
    otherwise handler threads of keep-alive clients go on answering after
    the server has stopped."""

    daemon_threads = True
    # the default backlog of 5 drops SYNs under a burst of new connections
    request_queue_size = 1024

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._live: set = set()
        self._live_lock = threading.Lock()
        self._closing = False

    def process_request(self, request, client_address):
        with self._live_lock:
            if self._closing:
                _close_socket(request)
                return
            self._live.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_lock:
            self._live.discard(request)
        super().shutdown_request(request)

    def shutdown(self):
        super().shutdown()
        with self._live_lock:
            self._closing = True
            live, self._live = list(self._live), set()
        for sock in live:
            _close_socket(sock)


def start_server(handler_cls, host: str, port: int) -> _Server:
    """Serve ``handler_cls`` on (host, port) from a background thread. The
    caller stops it with ``shutdown()`` and ``server_close()``."""
    srv = _Server((host, port), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"http-{host}:{srv.server_address[1]}").start()
    return srv


def http_bytes_headers(method: str, url: str, body: Optional[bytes] = None,
                       timeout: float = 30.0,
                       headers: Optional[dict] = None) -> tuple[int, bytes, dict]:
    """One request on a fresh connection -> (status, body, reply headers).
    An unreachable peer raises OSError; HTTP error statuses come back as
    statuses. Some admin replies carry metadata in headers
    (X-Compaction-Revision, X-Last-Append-Ns)."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request(method, u.path + (f"?{u.query}" if u.query else ""),
                     body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def http_bytes(method: str, url: str, body: Optional[bytes] = None,
               timeout: float = 30.0,
               headers: Optional[dict] = None) -> tuple[int, bytes]:
    """One request on a fresh connection -> (status, body)."""
    status, data, _ = http_bytes_headers(method, url, body, timeout, headers)
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
