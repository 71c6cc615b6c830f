"""A directory-backed S3 stand-in: the tier endpoint of the tests and of the
GPU check.

Just enough of the S3 REST surface for ``S3BackendStorage`` and
``RemoteS3File`` (through ``s3api.s3_client.S3Client``) to tier volumes
against it:

    PUT    /bucket                          create bucket
    PUT    /bucket/key                      put object
    POST   /bucket/key?uploads              initiate multipart -> UploadId
    PUT    /bucket/key?partNumber&uploadId  upload part
    POST   /bucket/key?uploadId             complete multipart (concatenate)
    DELETE /bucket/key?uploadId             abort multipart
    GET    /bucket/key [Range: bytes=a-b]   (ranged) get object
    HEAD   /bucket/key                      size probe
    DELETE /bucket[/key]                    delete

Objects are plain files under ``root/bucket/key``, so a test can corrupt or
inspect the cold tier directly. SigV4 ``Authorization`` headers are accepted
and not checked: signing is the client's concern, this server fakes only
storage. ``ranged_gets`` lists (seconds to serve, bytes) of each ranged
GET, so a caller can read the tier's latency from the server's side.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ...util.parsers import parse_ascii_uint, tolerant_uint


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "FakeS3/0.1"
    # the head and the body leave in two sends: without TCP_NODELAY the body
    # waits for the client's delayed ACK of the head (~40 ms a GET)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        pass

    def _split(self):
        parsed = urllib.parse.urlparse(self.path)
        q = dict(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        parts = parsed.path.strip("/").split("/", 1)
        return parts[0], (parts[1] if len(parts) > 1 else ""), q

    def _obj_path(self, bucket: str, key: str) -> str:
        # keys stay flat (collection_vid.dat); no traversal
        safe = key.replace("/", "_").replace("..", "_")
        return os.path.join(self.server.root, bucket, safe)

    def _reply(self, status: int, body: bytes = b"", headers=None):
        self.send_response(status)
        hdrs = dict(headers or {})
        for k, v in hdrs.items():
            self.send_header(k, v)
        # HEAD names the object's size itself: a second Content-Length (the
        # empty body's 0) would reach a strict client as "N, 0"
        if not any(k.lower() == "content-length" for k in hdrs):
            self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = tolerant_uint(self.headers.get("Content-Length", "0"), 0)
        return self.rfile.read(n) if n else b""

    def do_PUT(self):
        bucket, key, q = self._split()
        if not bucket:
            return self._reply(400)
        bdir = os.path.join(self.server.root, bucket)
        if not key:
            os.makedirs(bdir, exist_ok=True)
            return self._reply(200)
        if not os.path.isdir(bdir):
            return self._reply(404, b"<Error><Code>NoSuchBucket</Code></Error>")
        body = self._read_body()
        if "partNumber" in q and "uploadId" in q:
            try:
                pn = parse_ascii_uint(q["partNumber"])
            except ValueError:
                return self._reply(400)
            with self.server.lock:
                parts = self.server.uploads.get(q["uploadId"])
                if parts is None:
                    return self._reply(404)
                parts[pn] = body
            return self._reply(200, headers={"ETag": f'"{len(body):x}"'})
        with open(self._obj_path(bucket, key), "wb") as f:
            f.write(body)
        return self._reply(200, headers={"ETag": '"fake"'})

    def do_POST(self):
        bucket, key, q = self._split()
        if "uploads" in q:
            uid = uuid.uuid4().hex
            with self.server.lock:
                self.server.uploads[uid] = {}
            return self._reply(200, (f"<InitiateMultipartUploadResult><UploadId>{uid}"
                                     "</UploadId></InitiateMultipartUploadResult>").encode())
        if "uploadId" in q:
            self._read_body()
            with self.server.lock:
                parts = self.server.uploads.pop(q["uploadId"], None)
            if parts is None:
                return self._reply(404)
            with open(self._obj_path(bucket, key), "wb") as f:
                for num in sorted(parts):
                    f.write(parts[num])
            return self._reply(200, b"<CompleteMultipartUploadResult/>")
        return self._reply(400)

    def do_GET(self):
        t0 = time.perf_counter()
        bucket, key, _ = self._split()
        if not bucket:
            return self._reply(200, b"<ListAllMyBucketsResult/>")
        path = self._obj_path(bucket, key) if key else ""
        if not key or not os.path.isfile(path):
            return self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>")
        size = os.path.getsize(path)
        m = re.match(r"bytes=(\d+)-(\d*)$", self.headers.get("Range", ""))
        with open(path, "rb") as f:
            if not m:
                return self._reply(200, f.read())
            start = int(m.group(1))
            end = min(int(m.group(2)) if m.group(2) else size - 1, size - 1)
            if start > end:
                return self._reply(416)
            f.seek(start)
            data = f.read(end - start + 1)
        self._reply(206, data, headers={"Content-Range": f"bytes {start}-{end}/{size}"})
        with self.server.lock:
            self.server.ranged_gets.append((time.perf_counter() - t0, len(data)))

    def do_HEAD(self):
        bucket, key, _ = self._split()
        path = self._obj_path(bucket, key) if bucket and key else ""
        if not path or not os.path.isfile(path):
            return self._reply(404)
        return self._reply(200, headers={"Content-Length": str(os.path.getsize(path))})

    def do_DELETE(self):
        bucket, key, q = self._split()
        if "uploadId" in q:
            with self.server.lock:
                self.server.uploads.pop(q["uploadId"], None)
            return self._reply(204)
        if bucket and key:
            try:
                # sweedlint: ok durability fake-S3 object store under the test root, not the volume data plane; S3 DeleteObject has no staged-commit semantics to preserve
                os.unlink(self._obj_path(bucket, key))
            except FileNotFoundError:
                pass
            return self._reply(204)
        if bucket:
            shutil.rmtree(os.path.join(self.server.root, bucket), ignore_errors=True)
            return self._reply(204)
        return self._reply(400)


class FakeS3Server:
    """``with FakeS3Server(root) as s3: ... s3.endpoint ...``"""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        os.makedirs(root, exist_ok=True)
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.root = root
        self._srv.lock = threading.Lock()
        self._srv.uploads = {}  # uploadId -> {partNumber: bytes}
        self._srv.ranged_gets = []  # (seconds to serve, bytes) of each ranged GET
        self._thread: threading.Thread | None = None
        self.root = root
        self.host, self.port = self._srv.server_address[:2]
        self.endpoint = f"http://{self.host}:{self.port}"

    @property
    def ranged_gets(self) -> list[tuple[float, int]]:
        with self._srv.lock:
            return list(self._srv.ranged_gets)

    def start(self) -> "FakeS3Server":
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True,
                                        name=f"fake-s3-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self) -> "FakeS3Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def object_path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, bucket, key.replace("/", "_"))


if __name__ == "__main__":
    # python -m seaweedfs_tpu_torch.storage.backend.fake_s3 ROOT [PORT]
    import sys

    srv = FakeS3Server(sys.argv[1], port=int(sys.argv[2]) if len(sys.argv) > 2 else 8333)
    print(f"fake S3 on {srv.endpoint}, objects under {srv.root}", flush=True)
    srv._srv.serve_forever()
