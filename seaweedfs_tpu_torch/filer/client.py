"""Thin client over the filer's HTTP surface, used by the S3 gateway and the
fsspec adapter: the port of the JAX package's ``filer/client.py``.

Stands in for the reference's filer gRPC client (`s3api/filer_util.go`,
`filer_pb.SeaweedFiler`): entry-level lookup/create for multipart chunk-list
assembly, plus plain object read/write proxying.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Optional

from ..server.http_util import (
    http_bytes,
    http_bytes_headers,
    http_json,
    http_stream_request,
    http_stream_response,
)
from ..util.retry import READ_POLICY, RetryError, retry_call


class FilerHTTPError(IOError):
    """Non-2xx from the filer, with the status attached so retry
    classifiers can split transient (5xx/429) from poison (4xx) without
    parsing the message string."""

    def __init__(self, op: str, path: str, status: int, body: bytes = b""):
        super().__init__(f"{op} {path}: HTTP {status} {body[:200]!r}")
        self.status = status


class FilerClient:
    def __init__(self, filer_url: str, retry_reads: bool = True):
        self.base = f"http://{filer_url}"
        # idempotent reads ride the shared bounded-retry helper so a
        # connection reset mid-failover doesn't surface as a user error;
        # writes are NOT retried here — their callers (replication, s3
        # gateway) own retry policy and double-retrying multiplies load
        self._read_policy = READ_POLICY if retry_reads else None

    @staticmethod
    def _redirect_location(status: int, hdrs: dict) -> Optional[str]:
        """A sharded filer fleet answers reads for foreign paths with
        ``307 Location:`` (filer_server ring gate); a dumb client follows
        that ONE hop — the target answers with noRedirect, so there is
        never a chain. Writes aren't followed: the filer proxies those."""
        if status in (301, 302, 307, 308):
            return hdrs.get("Location") or hdrs.get("location")
        return None

    def _read(self, fn, *args, **kwargs):
        if self._read_policy is None:
            return fn(*args, **kwargs)
        try:
            return retry_call(fn, *args, policy=self._read_policy, **kwargs)
        except RetryError as e:
            raise e.last  # callers keep seeing the original URLError/OSError

    def _u(self, path: str, **q) -> str:
        qs = urllib.parse.urlencode({k: v for k, v in q.items() if v != ""})
        return self.base + urllib.parse.quote(path) + ("?" + qs if qs else "")

    # -- object level ---------------------------------------------------------
    # All four object calls ride the pooled keep-alive transport
    # (http_util): a gateway→filer hop per part/chunk no longer pays TCP
    # setup + slow-start; worker threads in the pipelined paths each keep
    # their own warm socket (the pool is thread-local).
    def put_object(
        self,
        path: str,
        body: bytes,
        content_type: str = "",
        extended: Optional[dict] = None,
        signatures: Optional[list[int]] = None,
    ) -> dict:
        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        for k, v in (extended or {}).items():
            headers[f"Seaweed-{k}"] = v
        status, data, _ = http_bytes_headers(
            "PUT",
            self._u(path, sig=",".join(map(str, signatures or []))),
            body=body,
            timeout=60,
            headers=headers,
        )
        if status >= 300:
            raise FilerHTTPError("PUT", path, status, data)
        return json.loads(data)

    def put_object_stream(
        self,
        path: str,
        rfile,
        length: int,
        content_type: str = "",
        extended: Optional[dict] = None,
    ) -> dict:
        """PUT with the body streamed from a file-like source: http.client's
        blocksize loop feeds the pooled socket, and the filer's streaming
        write path chunks it on arrival — an upload of any size flows
        end-to-end in bounded memory. The source is clamped to `length`
        bytes and a short read raises instead of silently truncating."""

        class _Exact:
            def __init__(self, src, left):
                self._src, self._left = src, left

            def read(self, n=-1):
                if self._left <= 0:
                    return b""
                want = self._left if n is None or n < 0 else min(n, self._left)
                got = self._src.read(want)
                if not got:
                    raise IOError(f"source ended {self._left} bytes early")
                self._left -= len(got)
                return got

        headers = {}
        if content_type:
            headers["Content-Type"] = content_type
        for k, v in (extended or {}).items():
            headers[f"Seaweed-{k}"] = v
        status, data, _ = http_stream_request(
            "PUT", self._u(path), _Exact(rfile, length), length,
            headers=headers, timeout=600,
        )
        if status >= 300:
            raise FilerHTTPError("PUT", path, status, data)
        return json.loads(data)

    def get_object_stream(
        self, path: str, rng: Optional[str] = None
    ) -> tuple[int, object, dict]:
        """GET whose body stays ON THE WIRE: returns (status, file-like
        response, headers) so gateways can pass bytes through piecewise
        instead of buffering whole objects (pairs with the filer's
        streaming read path). The caller must .close() the response; error
        statuses return the (small) error body as bytes instead."""
        headers = {"Range": rng} if rng else None
        status, body, hdrs = http_stream_response(
            "GET", self._u(path), headers=headers, timeout=600,
        )
        loc = self._redirect_location(status, hdrs)
        if loc:
            if hasattr(body, "read"):
                try:
                    body.read()  # tiny JSON; settle framing → repool
                finally:
                    body.close()
            status, body, hdrs = http_stream_response(
                "GET", loc, headers=headers, timeout=600,
            )
        return status, body, hdrs

    def get_object(
        self, path: str, rng: Optional[str] = None
    ) -> tuple[int, bytes, dict]:
        headers = {"Range": rng} if rng else None

        def go():
            status, data, hdrs = http_bytes_headers(
                "GET", self._u(path), headers=headers, timeout=60,
            )
            loc = self._redirect_location(status, hdrs)
            if loc:
                status, data, hdrs = http_bytes_headers(
                    "GET", loc, headers=headers, timeout=60,
                )
            return status, data, hdrs

        return self._read(go)

    def select(self, path: str, request_xml: bytes) -> tuple[int, bytes, dict]:
        """POST the raw SelectObjectContent request XML to the filer's
        /_select for ``path`` → (status, event_stream_bytes, error_dict).
        On success the body is the framed AWS event stream; on rejection
        the filer's JSON error (with its S3 ``error_code``) is decoded so
        the gateway can map it onto the wire."""
        status, data, _ = http_bytes_headers(
            "POST",
            self.base + "/_select?"
            + urllib.parse.urlencode({"path": path}),
            body=request_xml,
            timeout=600,
            headers={"Content-Type": "application/xml"},
        )
        if status == 200:
            return 200, data, {}
        try:
            err = json.loads(data)
        except ValueError:
            err = {"error": data.decode("utf-8", "replace")[:200]}
        return status, b"", err

    # -- entry level ----------------------------------------------------------
    def get_entry(self, path: str) -> Optional[dict]:
        def go():
            status, body, hdrs = http_bytes_headers(
                "GET", self._u(path, meta="true")
            )
            loc = self._redirect_location(status, hdrs)
            if loc:
                status, body, hdrs = http_bytes_headers("GET", loc)
            return status, body

        status, body = self._read(go)
        if status != 200:
            return None
        return json.loads(body)

    def create_entry(
        self, path: str, entry: dict, signatures: Optional[list[int]] = None
    ) -> None:
        http_json(
            "POST",
            self._u(
                path, meta="true", sig=",".join(map(str, signatures or []))
            ),
            body=entry,
        )

    def mkdir(self, path: str, signatures: Optional[list[int]] = None) -> None:
        http_json(
            "POST",
            self._u(
                path.rstrip("/") + "/", mkdir="true",
                sig=",".join(map(str, signatures or [])),
            ),
        )

    def delete(
        self,
        path: str,
        recursive: bool = False,
        skip_chunk_purge: bool = False,
        signatures: Optional[list[int]] = None,
    ) -> int:
        status, _ = http_bytes(
            "DELETE",
            self._u(
                path,
                recursive="true" if recursive else "",
                ignoreRecursiveError="true" if recursive else "",
                skipChunkPurge="true" if skip_chunk_purge else "",
                sig=",".join(map(str, signatures or [])),
            ),
        )
        return status

    def list(
        self,
        dir_path: str,
        start_after: str = "",
        limit: int = 1000,
        prefix: str = "",
    ) -> list[dict]:
        url = self._u(
            dir_path.rstrip("/") + "/",
            meta="true",
            lastFileName=start_after,
            limit=str(limit),
            prefix=prefix,
        )

        def go():
            status, body, hdrs = http_bytes_headers("GET", url)
            loc = self._redirect_location(status, hdrs)
            if loc:
                status, body, hdrs = http_bytes_headers("GET", loc)
            return status, body

        status, body = self._read(go)
        if status != 200:
            return []
        return json.loads(body).get("entries", [])

    def rename(self, old: str, new: str) -> None:
        http_json("POST", self._u(old, **{"mv.to": new}))

    def assign(self, count: int = 1, collection: str = "", ttl: str = "") -> dict:
        """AssignVolume through the filer (pb/filer.proto AssignVolume) —
        write-through clients (mount) get fids without master access."""
        return http_json(
            "GET",
            self.base
            + f"/_assign?count={count}&collection={collection}&ttl={ttl}",
        )

    # -- meta subscribe / kv / status ----------------------------------------
    def status(self) -> dict:
        return self._read(http_json, "GET", self.base + "/_status")

    def meta_events(self, since_ns: int = 0, limit: int = 1000) -> dict:
        return self._read(
            http_json,
            "GET",
            self.base + f"/_meta/events?since_ns={since_ns}&limit={limit}",
        )

    def kv_put(self, key: str, value: bytes) -> None:
        http_bytes("PUT", self.base + "/_kv/" + urllib.parse.quote(key), value)

    def kv_get(self, key: str) -> Optional[bytes]:
        status, body = self._read(
            http_bytes, "GET", self.base + "/_kv/" + urllib.parse.quote(key)
        )
        return body if status == 200 else None

    def kv_delete(self, key: str) -> None:
        http_bytes("DELETE", self.base + "/_kv/" + urllib.parse.quote(key))
