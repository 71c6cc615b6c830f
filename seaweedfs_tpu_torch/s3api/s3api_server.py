"""S3-compatible REST server over the filer.

Mirrors `weed/s3api/s3api_server.go:38` (router) and its handler files:
bucket CRUD (= dirs under `/buckets`, `s3api_bucket_handlers.go`), object
CRUD proxied to the filer (`s3api_object_handlers.go`), multipart uploads
assembled by chunk-list concatenation without data copy
(`filer_multipart.go`), ListObjects v1/v2 (`s3api_objects_list_handlers.go`),
object tagging (`s3api_object_tagging_handlers.go`), and multi-object delete.

Requests are authenticated by `auth.IAM` (SigV4 header/presigned/streaming +
SigV2) and authorized per identity action grants (`auth_credentials.go:124`).
SelectObjectContent is forwarded to the filer's ``/_select``, which scans on
the filer's device. The port of the JAX package's ``s3api/s3api_server.py``;
the filer layout is the same, so either package's gateway reads what the
other's wrote.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
import uuid
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler

from ..server.http_util import (
    CountedReader,
    has_dot_segments,
    drain_refused_body,
    parse_content_length,
    relay_stream,
    start_server,
)
from ..stats import trace as _trace
from ..stats.metrics import default_registry
from ..util.parsers import parse_ascii_uint
from ..util.pipeline import BoundedExecutor, prefetch_iter
from . import auth as s3auth
from . import policy_engine as pe
from . import post_policy as pp
from .auth import IAM
from .xml_util import error_xml, find_text, findall, parse_xml, to_xml

BUCKETS_DIR = "/buckets"
UPLOADS_DIR = "/buckets/.uploads"
TAG_PREFIX = "X-Amz-Tag-"

_ERR_STATUS = {
    "NoSuchBucket": 404,
    "NoSuchKey": 404,
    "NoSuchUpload": 404,
    "AccessDenied": 403,
    "SignatureDoesNotMatch": 403,
    "InvalidAccessKeyId": 403,
    "ExpiredPresignRequest": 403,
    "MissingFields": 400,
    "MalformedXML": 400,
    "IncompleteBody": 400,
    "InvalidPart": 400,
    "InvalidArgument": 400,
    "BucketAlreadyExists": 409,
    "BucketNotEmpty": 409,
    "NoSuchBucketPolicy": 404,
    "AuthorizationHeaderMalformed": 400,
    "AuthorizationQueryParametersError": 400,
    # SelectObjectContent request rejections (query/select.py)
    "InvalidRequest": 400,
    "InvalidTextEncoding": 400,
    "InvalidExpressionType": 400,
    "InvalidCompressionFormat": 400,
    "UnsupportedSqlStructure": 400,
    "InternalError": 500,
}


def _parse_s3_int(s: str) -> int:
    """AWS-strict non-negative query integer (max-keys, partNumber):
    the shared ascii-digit parser, kept under its historical local name."""
    return parse_ascii_uint(s)


def _iso(ts: float) -> str:
    return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z"
    )


def _parse_copy_source(src: str) -> tuple[str, str]:
    """X-Amz-Copy-Source → (bucket, key); either may come back empty for a
    malformed header (s3api_object_copy_handlers.go pathToBucketAndObject)."""
    src = urllib.parse.unquote(src)
    sb, _, sk = src.lstrip("/").partition("/")
    return sb, sk


class S3ApiServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8333,
        filer_url: str = "127.0.0.1:8888",
        iam: IAM | None = None,
        tls_cert: str = "",
        tls_key: str = "",
        tls_ca: str = "",
    ):
        self.host, self.port = host, port
        # one address: a plain FilerClient; a comma list of a filer
        # fleet's members: a RingFilerClient (filer/ring.py make_client)
        from ..filer.ring import make_client

        self.client = make_client(filer_url)
        # object/bucket op latency; op label is method × path-kind (bounded)
        self._req_hist = default_registry.histogram(
            "s3_request_seconds", "s3 gateway request latency"
        )
        self.iam = iam or IAM()
        self._policy_cache: dict = {}  # bucket → (BucketPolicy | None,)
        self._policy_lock = threading.Lock()  # handler threads race the cache
        self._policy_gen: dict = {}  # bucket → invalidation generation
        self._tls = (tls_cert, tls_key, tls_ca)
        self._srv = None

    # ---------------------------------------------------------------- helpers
    def _bucket_dir(self, bucket: str) -> str:
        return f"{BUCKETS_DIR}/{bucket}"

    def _object_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_DIR}/{bucket}/{key}"

    def _bucket_exists(self, bucket: str) -> bool:
        e = self.client.get_entry(self._bucket_dir(bucket))
        return bool(e and e.get("is_directory"))

    # ---------------------------------------------------------------- service
    def _list_buckets(self, identity):
        buckets = [
            {"Name": e["name"], "CreationDate": _iso(e.get("crtime", 0))}
            for e in self.client.list(BUCKETS_DIR, limit=10000)
            if e.get("is_directory") and not e["name"].startswith(".")
        ]
        return 200, to_xml(
            "ListAllMyBucketsResult",
            {
                "Owner": {"ID": getattr(identity, "name", "") or "anonymous"},
                "Buckets": {"Bucket": buckets},
            },
        )

    # ---------------------------------------------------------------- buckets
    def _put_bucket(self, bucket):
        if self._bucket_exists(bucket):
            return _err("BucketAlreadyExists", bucket)
        self.client.mkdir(self._bucket_dir(bucket))
        return 200, b""

    def _head_bucket(self, bucket):
        if not self._bucket_exists(bucket):
            return 404, b""
        return 200, b""

    def _delete_bucket(self, bucket):
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        self.client.delete(self._bucket_dir(bucket), recursive=True)
        # the policy dies with the bucket — a recreated namesake must not
        # inherit the old grants
        self.client.delete(f"{self.POLICIES_DIR}/{bucket}")
        with self._policy_lock:
            self._policy_gen[bucket] = self._policy_gen.get(bucket, 0) + 1
            self._policy_cache.pop(bucket, None)
        return 204, b""

    # ------------------------------------------------------------ list objects
    def _iter_keys(self, dir_path, rel, prefix, marker):
        """Sorted recursive key walk with prefix/marker subtree pruning."""
        start = ""
        entries = self.client.list(dir_path, start_after=start, limit=100000)
        for e in entries:
            if rel == "" and e["name"].startswith("."):
                continue  # .uploads &co at bucket root
            key = rel + e["name"]
            if e.get("is_directory"):
                sub = key + "/"
                if prefix and not (
                    prefix.startswith(sub[: len(prefix)])
                    or sub.startswith(prefix)
                ):
                    continue
                if marker and sub <= marker and not marker.startswith(sub):
                    continue
                yield from self._iter_keys(
                    dir_path + "/" + e["name"], sub, prefix, marker
                )
            else:
                yield key, e

    def _list_objects(self, bucket, q, v2: bool):
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        try:
            max_keys = _parse_s3_int(q.get("max-keys", "1000"))
        except ValueError:
            return _err("InvalidArgument", bucket,
                        "max-keys must be a non-negative integer")
        if v2:
            marker = q.get("continuation-token", "") or q.get("start-after", "")
        else:
            marker = q.get("marker", "")
        contents, common = [], []
        truncated = False
        keys_iter = (
            self._iter_keys(self._bucket_dir(bucket), "", prefix, marker)
            if max_keys > 0 else ()
            # max-keys=0 is an empty NON-truncated listing (AWS semantics);
            # entering the loop would emit IsTruncated=true with an empty
            # continuation token and trap v2 paginators in a loop
        )
        for key, e in keys_iter:
            if prefix and not key.startswith(prefix):
                continue
            if marker and key <= marker:
                continue
            if delimiter:
                idx = key.find(delimiter, len(prefix))
                if idx >= 0:
                    cp = key[: idx + len(delimiter)]
                    if marker and cp <= marker:
                        continue  # whole prefix was already returned
                    if common and common[-1] == cp:
                        continue
                    if len(contents) + len(common) >= max_keys:
                        truncated = True
                        break
                    common.append(cp)
                    continue
            if len(contents) + len(common) >= max_keys:
                truncated = True
                break
            size = max(
                (c["offset"] + c["size"] for c in e.get("chunks", [])), default=0
            )
            contents.append(
                {
                    "Key": key,
                    "LastModified": _iso(e.get("mtime", 0)),
                    "ETag": f'"{e.get("extended", {}).get("md5", "")}"',
                    "Size": size,
                    "StorageClass": "STANDARD",
                }
            )
        # marker is exclusive: the next page starts after the last returned
        # key/prefix (S3 v1 NextMarker / v2 continuation semantics)
        last_key = contents[-1]["Key"] if contents else ""
        last_cp = common[-1] if common else ""
        next_marker = max(last_key, last_cp)
        result = {
            "Name": bucket,
            "Prefix": prefix,
            "MaxKeys": max_keys,
            "Delimiter": delimiter,
            "IsTruncated": truncated,
            "Contents": contents,
            "CommonPrefixes": [{"Prefix": p} for p in common],
        }
        if v2:
            result["KeyCount"] = len(contents) + len(common)
            if truncated:
                result["NextContinuationToken"] = next_marker
        else:
            result["Marker"] = marker
            if truncated:
                result["NextMarker"] = next_marker
        return 200, to_xml("ListBucketResult", result)

    # ---------------------------------------------------------------- objects
    def _put_object(self, bucket, key, headers, body):
        streamed = isinstance(body, tuple)  # (reader, length) pass-through
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        if key.endswith("/"):
            if streamed:
                body[0].drain()  # directory markers carry no meaningful body
            self.client.mkdir(self._object_path(bucket, key[:-1]))
            return 200, b"", {"ETag": '"d41d8cd98f00b204e9800998ecf8427e"'}
        src = headers.get("X-Amz-Copy-Source", "")
        if src:
            return self._copy_object(bucket, key, src)
        body, chunk_err = self._decode_chunked(headers, body, key)
        if chunk_err is not None:
            return chunk_err
        extended = {
            k.title(): v
            for k, v in headers.items()
            if k.lower().startswith("x-amz-meta-")
        }
        if streamed:
            reader, length = body
            r = self.client.put_object_stream(
                self._object_path(bucket, key), reader, length,
                content_type=headers.get("Content-Type", ""),
                extended=extended,
            )
        else:
            r = self.client.put_object(
                self._object_path(bucket, key),
                body,
                content_type=headers.get("Content-Type", ""),
                extended=extended,
            )
        return 200, b"", {"ETag": f'"{r.get("eTag", "")}"'}

    def _decode_chunked(self, headers, body, key):
        """Undo STREAMING-AWS4-HMAC-SHA256-PAYLOAD framing, verifying the
        per-chunk signature chain. Returns (body, None) — body unchanged
        when the request wasn't aws-chunked — or (None, error_response)."""
        if headers.get("X-Amz-Content-Sha256") != s3auth.STREAMING_PAYLOAD:
            return body, None
        # the streaming auth context is built OUTSIDE the framing try: a
        # ValueError here (e.g. malformed credential scope unpack) is an
        # auth/header problem and must not masquerade as IncompleteBody
        try:
            verify = self.iam.streaming_context(headers)
        except ValueError:
            return None, _err("AuthorizationHeaderMalformed", key,
                              "malformed credential scope")
        try:
            return s3auth.decode_aws_chunked(body, verify=verify), None
        except s3auth.ChunkSignatureError:
            return None, _err("SignatureDoesNotMatch", key)
        except ValueError:
            # malformed chunk framing (bad hex size / missing CRLF) must be
            # the client's 400, not an unhandled 500
            return None, _err("IncompleteBody", key)

    def _copy_object(self, bucket, key, src):
        sb, sk = _parse_copy_source(src)
        if not sb or not sk:
            return _err("InvalidCopySource", src)
        status, data, _ = self.client.get_object(self._object_path(sb, sk))
        if status != 200:
            return _err("NoSuchKey", src)
        entry = self.client.get_entry(self._object_path(sb, sk)) or {}
        dst_path = self._object_path(bucket, key)
        r = self.client.put_object(
            dst_path, data, content_type=entry.get("mime", "")
        )
        # S3's default COPY directive carries user metadata + tags along
        src_ext = {
            k: v for k, v in entry.get("extended", {}).items() if k != "md5"
        }
        if src_ext:
            dst = self.client.get_entry(dst_path)
            if dst is not None:
                dst["extended"] = src_ext | {"md5": dst["extended"].get("md5", "")}
                self.client.create_entry(dst_path, dst)
        return 200, to_xml(
            "CopyObjectResult",
            {"ETag": f'"{r.get("eTag", "")}"', "LastModified": _iso(time.time())},
        )

    def _get_acl(self, bucket, key=None):
        """Canned owner/FULL_CONTROL ACL for bucket and object ?acl probes.
        The reference leaves ACL routes unimplemented (s3api_server.go:
        108-117, commented out); SDKs that probe ACLs (boto3, rclone) still
        need a well-formed AccessControlPolicy rather than a bucket listing,
        so we serve the constant view — real access control is the IAM
        policy layer."""
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        if key is not None:
            entry = self.client.get_entry(self._object_path(bucket, key))
            if entry is None or entry.get("is_directory"):
                return _err("NoSuchKey", key)
        owner = {"ID": "seaweedfs", "DisplayName": "seaweedfs"}
        return 200, to_xml(
            "AccessControlPolicy",
            {
                "Owner": owner,
                "AccessControlList": {
                    "Grant": {"Grantee": owner, "Permission": "FULL_CONTROL"}
                },
            },
        )

    def _select_object(self, bucket, key, query, body):
        """SelectObjectContent (POST /bucket/key?select&select-type=2):
        validate the request XML at the gateway so protocol errors never
        round-trip, then run the scan on the filer — next to its
        prefetching chunk stream — and relay the framed event stream."""
        if query.get("select-type") != "2":
            return _err(
                "InvalidRequest", key, "select-type=2 is required"
            )
        from ..query import select as s3select

        try:
            s3select.parse_select_request(body)
        except s3select.SelectError as e:
            return _err(e.code, key, e.message)
        path = self._object_path(bucket, key)
        entry = self.client.get_entry(path)
        if entry is None or entry.get("is_directory"):
            return _err("NoSuchKey", key)
        status, payload, err = self.client.select(path, body)
        if status != 200:
            return _err(
                err.get("error_code") or "InternalError",
                key,
                err.get("error", ""),
            )
        return 200, payload, {"Content-Type": "application/octet-stream"}

    def _get_object(self, bucket, key, headers, head=False):
        path = self._object_path(bucket, key)
        entry = self.client.get_entry(path)
        if entry is None or entry.get("is_directory"):
            return _err("NoSuchKey", key)
        size = max(
            (c["offset"] + c["size"] for c in entry.get("chunks", [])), default=0
        )
        resp_headers = {
            "Content-Type": entry.get("mime") or "application/octet-stream",
            "ETag": f'"{entry.get("extended", {}).get("md5", "")}"',
            "Last-Modified": datetime.fromtimestamp(
                entry.get("mtime", 0), tz=timezone.utc
            ).strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "Accept-Ranges": "bytes",
        }
        for k, v in entry.get("extended", {}).items():
            if k.startswith("X-Amz-Meta-"):
                resp_headers[k] = v
        if head:
            resp_headers["Content-Length-Override"] = str(size)
            return 200, b"", resp_headers
        rng = headers.get("Range", "")
        status, data, h = self.client.get_object_stream(path, rng=rng or None)
        if status not in (200, 206):
            if hasattr(data, "close"):
                data.close()
            return _err("NoSuchKey", key)
        if status == 206 and "Content-Range" in h:
            resp_headers["Content-Range"] = h["Content-Range"]
        clen = h.get("Content-Length")
        if clen is None:
            # without an upstream length a relayed body would corrupt
            # keep-alive framing; the filer always sends one, so this is
            # a broken upstream — fail loudly instead
            data.close()
            return _err("InternalError", key)
        # file-like body: the handler streams it through in pieces
        resp_headers["Content-Length-Override"] = clen
        return status, data, resp_headers

    async def _get_object_native(self, h, path, query):
        """Native-async GetObject: SigV4/SigV2 verification is pure HMAC
        (runs on the loop), bucket policy comes from the cache ONLY, and
        both the entry lookup and the body ride the asyncio pooled
        transport to the filer. Every edge falls back to the bridged
        handler for canonical error/XML bytes: sub-resources and
        presigned URLs (query params), auth failures, anonymous access,
        uncached policies, missing keys, directories."""
        from ..server.aio_transport import AStreamBody
        from ..server.aio_transport import request as arequest
        from ..server.aio_transport import stream as astream
        from ..server.http_util import NATIVE_FALLBACK, AsyncStreamBody

        if query:
            return NATIVE_FALLBACK  # ?subresource / presigned stay bridged
        headers = {k.title(): v for k, v in h.headers.items()}
        try:
            identity, err = self.iam.authenticate(
                "GET", path, query, headers, b""
            )
        except Exception:  # noqa: BLE001 — bridge renders the auth error
            return NATIVE_FALLBACK
        if err:
            return NATIVE_FALLBACK  # incl. anonymous: policy Allow is rare
        upath = urllib.parse.unquote(path)
        parts = upath.lstrip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
        if not bucket or not key or bucket.startswith("."):
            return NATIVE_FALLBACK  # service/bucket ops, internal dirs
        with self._policy_lock:
            cached = self._policy_cache.get(bucket)
        if cached is None:
            return NATIVE_FALLBACK  # bridge fetches + caches the policy
        pol = cached[0]
        verdict = None
        if pol is not None:
            verdict = pe.evaluate(
                pol,
                identity.access_key if identity else "",
                pe.ACTION_NAMES.get(s3auth.ACTION_READ, "s3:*"),
                pe.arn(bucket, key),
            )
        if verdict is None:
            verdict = identity is None or identity.can_do(
                s3auth.ACTION_READ, bucket
            )
        if not verdict:
            return NATIVE_FALLBACK  # canonical AccessDenied stays bridged
        t0 = time.monotonic()
        opath = self._object_path(bucket, key)
        try:
            status, body, _ = await arequest(
                "GET", self.client._u(opath, meta="true")
            )
        except Exception:  # noqa: BLE001 — bridged client owns retries
            return NATIVE_FALLBACK
        if status != 200:
            return NATIVE_FALLBACK  # canonical NoSuchKey stays bridged
        entry = json.loads(body)
        if entry.get("is_directory"):
            return NATIVE_FALLBACK
        resp_headers = {
            "Content-Type": entry.get("mime") or "application/octet-stream",
            "ETag": f'"{entry.get("extended", {}).get("md5", "")}"',
            "Last-Modified": datetime.fromtimestamp(
                entry.get("mtime", 0), tz=timezone.utc
            ).strftime("%a, %d %b %Y %H:%M:%S GMT"),
            "Accept-Ranges": "bytes",
        }
        for k, v in entry.get("extended", {}).items():
            if k.startswith("X-Amz-Meta-"):
                resp_headers[k] = v
        rng = headers.get("Range", "")
        try:
            status, data, rh = await astream(
                "GET", self.client._u(opath),
                headers={"Range": rng} if rng else None,
            )
        except Exception:  # noqa: BLE001
            return NATIVE_FALLBACK
        if status not in (200, 206) or not isinstance(data, AStreamBody):
            if hasattr(data, "close"):
                data.close()
            return NATIVE_FALLBACK
        if data.length is None:
            data.close()
            return NATIVE_FALLBACK  # unframed upstream: bridge fails loudly
        if status == 206 and "content-range" in rh:
            resp_headers["Content-Range"] = rh["content-range"]

        async def pieces(src):
            try:
                while True:
                    chunk = await src.read(1 << 16)
                    if not chunk:
                        break
                    yield chunk
            finally:
                src.close()
                self._req_hist.observe(
                    time.monotonic() - t0, op="object_get"
                )

        return status, AsyncStreamBody(data.length, pieces(data)), resp_headers

    def _delete_object(self, bucket, key):
        path = self._object_path(bucket, key.rstrip("/"))
        entry = self.client.get_entry(path)
        if entry is None:
            return 204, b""  # S3: deleting a missing key succeeds
        if entry.get("is_directory"):
            if key.endswith("/"):
                # explicit dir marker: remove only if empty (non-recursive)
                self.client.delete(path)
            # a bare key that happens to be an implicit directory is NOT the
            # object the client named — never recursively wipe the prefix
            return 204, b""
        self.client.delete(path)
        return 204, b""

    def _delete_multiple(self, bucket, body, can_delete=None):
        try:
            root = parse_xml(body)
        except Exception:
            return _err("MalformedXML", bucket)
        deleted, errors = [], []
        for obj in findall(root, "Object"):
            key = find_text(obj, "Key")
            if not key:
                continue
            if can_delete is not None and not can_delete(key):
                errors.append({"Key": key, "Code": "AccessDenied"})
                continue
            status, _ = self._delete_object(bucket, key)
            if status in (200, 204):
                deleted.append({"Key": key})
            else:
                errors.append({"Key": key, "Code": "InternalError"})
        return 200, to_xml(
            "DeleteResult", {"Deleted": deleted, "Error": errors}
        )

    # ---------------------------------------------------------------- tagging
    def _get_tagging(self, bucket, key):
        entry = self.client.get_entry(self._object_path(bucket, key))
        if entry is None:
            return _err("NoSuchKey", key)
        tags = [
            {"Key": k[len(TAG_PREFIX) :], "Value": v}
            for k, v in entry.get("extended", {}).items()
            if k.startswith(TAG_PREFIX)
        ]
        return 200, to_xml("Tagging", {"TagSet": {"Tag": tags}})

    def _put_tagging(self, bucket, key, body):
        path = self._object_path(bucket, key)
        entry = self.client.get_entry(path)
        if entry is None:
            return _err("NoSuchKey", key)
        try:
            root = parse_xml(body)
        except Exception:
            return _err("MalformedXML", key)
        ext = {
            k: v
            for k, v in entry.get("extended", {}).items()
            if not k.startswith(TAG_PREFIX)
        }
        for tag in findall(root, "Tag"):
            ext[TAG_PREFIX + find_text(tag, "Key")] = find_text(tag, "Value")
        entry["extended"] = ext
        self.client.create_entry(path, entry)
        return 200, b""

    def _delete_tagging(self, bucket, key):
        path = self._object_path(bucket, key)
        entry = self.client.get_entry(path)
        if entry is None:
            return _err("NoSuchKey", key)
        entry["extended"] = {
            k: v
            for k, v in entry.get("extended", {}).items()
            if not k.startswith(TAG_PREFIX)
        }
        self.client.create_entry(path, entry)
        return 204, b""

    # -------------------------------------------------------------- multipart
    def _initiate_multipart(self, bucket, key, headers):
        upload_id = uuid.uuid4().hex
        self.client.mkdir(f"{UPLOADS_DIR}/{upload_id}")
        now = int(time.time())
        self.client.create_entry(
            f"{UPLOADS_DIR}/{upload_id}/.info",
            {
                "extended": {
                    "bucket": bucket,
                    "key": key,
                    "content-type": headers.get("Content-Type", ""),
                },
                "mtime": now,
                "crtime": now,
            },
        )
        return 200, to_xml(
            "InitiateMultipartUploadResult",
            {"Bucket": bucket, "Key": key, "UploadId": upload_id},
        )

    def _upload_part(self, bucket, key, q, body, headers):
        upload_id = q["uploadId"]
        try:
            part = _parse_s3_int(q["partNumber"])
        except (KeyError, ValueError):
            return _err("InvalidArgument", key,
                        "partNumber must be an integer")
        if not 1 <= part <= 10000:
            # AWS bounds; the part file name is a 5-digit field, so name
            # order == numeric order across the whole range
            return _err("InvalidArgument", key,
                        "partNumber must be between 1 and 10000")
        if self.client.get_entry(f"{UPLOADS_DIR}/{upload_id}/.info") is None:
            return _err("NoSuchUpload", upload_id)
        if headers.get("X-Amz-Copy-Source"):
            # UploadPartCopy: the part's bytes come from an existing object,
            # not the request body (the reference routes this shape to a
            # dedicated handler — s3api_server.go:61 → CopyObjectPartHandler)
            return self._copy_part(
                upload_id,
                part,
                headers["X-Amz-Copy-Source"],
                headers.get("X-Amz-Copy-Source-Range", ""),
            )
        body, chunk_err = self._decode_chunked(headers, body, key)
        if chunk_err is not None:
            return chunk_err
        r = self.client.put_object(
            f"{UPLOADS_DIR}/{upload_id}/{part:05d}.part", body
        )
        return 200, b"", {"ETag": f'"{r.get("eTag", "")}"'}

    def _copy_part(self, upload_id, part, src, rng):
        """UploadPartCopy: server-side copy of (a range of) an existing
        object into a multipart part (s3api_object_copy_handlers.go:84
        CopyObjectPartHandler). The source streams filer→filer piecewise so
        multi-GB parts copy in bounded gateway memory."""
        sb, sk = _parse_copy_source(src)
        if not sb or not sk:
            return _err("InvalidCopySource", src)
        src_path = self._object_path(sb, sk)
        entry = self.client.get_entry(src_path)
        if entry is None or entry.get("is_directory"):
            return _err("InvalidCopySource", src)
        status, resp, h = self.client.get_object_stream(src_path, rng=rng or None)
        if status not in (200, 206):
            if hasattr(resp, "close"):
                resp.close()
            return _err("InvalidCopySource", src)
        if rng and status != 206:
            # a Range the source ignored must not silently copy everything
            resp.close()
            return _err("InvalidRange", src)
        clen = h.get("Content-Length")
        if clen is None:
            # a lengthless upstream would store a truncated/empty part and
            # CompleteMultipartUpload would then assemble silent corruption;
            # the filer always sends one, so fail loudly (same stance as
            # _get_object)
            resp.close()
            return _err("InternalError", src)
        length = int(clen)
        try:
            r = self.client.put_object_stream(
                f"{UPLOADS_DIR}/{upload_id}/{part:05d}.part", resp, length
            )
        finally:
            resp.close()
        return 200, to_xml(
            "CopyPartResult",
            {
                "LastModified": _iso(time.time()),
                "ETag": f'"{r.get("eTag", "")}"',
            },
        )

    def _complete_multipart(self, bucket, key, q, body):
        """Chunk-list concatenation, no data copy (filer_multipart.go
        CompleteMultipartUpload)."""
        upload_id = q["uploadId"]
        info = self.client.get_entry(f"{UPLOADS_DIR}/{upload_id}/.info")
        if info is None:
            return _err("NoSuchUpload", upload_id)
        try:
            root = parse_xml(body)
            part_numbers = [
                int(find_text(p, "PartNumber")) for p in findall(root, "Part")
            ]
        except Exception:
            return _err("MalformedXML", key)
        if len(set(part_numbers)) != len(part_numbers):
            # a duplicated PartNumber would assemble that part's chunks
            # twice; AWS rejects the request rather than guessing
            return _err("InvalidPart", key, "duplicate part number")
        def _part_entry(part):
            pe = self.client.get_entry(
                f"{UPLOADS_DIR}/{upload_id}/{part:05d}.part"
            )
            if pe is None:
                # uploads in flight across the 04d→05d field-width upgrade
                # stored their parts under the legacy name; completing them
                # must find (and purge) those too
                pe = self.client.get_entry(
                    f"{UPLOADS_DIR}/{upload_id}/{part:04d}.part"
                )
            return pe

        # part metadata fetches are independent filer round-trips; a
        # windowed prefetch (util/pipeline.py) overlaps them while this
        # thread assembles the chunk list strictly in part order
        chunks, md5_digests, offset = [], [], 0
        fetched = prefetch_iter(sorted(part_numbers), _part_entry, window=8)
        try:
            for part, pe in fetched:
                if pe is None:
                    return _err("InvalidPart", str(part))
                md5_digests.append(
                    bytes.fromhex(pe.get("extended", {}).get("md5", ""))
                )
                for c in sorted(pe.get("chunks", []), key=lambda c: c["offset"]):
                    c = dict(c)
                    c["offset"] = offset + c["offset"]
                    chunks.append(c)
                offset = max(
                    (c["offset"] + c["size"] for c in chunks), default=offset
                )
        finally:
            fetched.close()
        etag = hashlib.md5(b"".join(md5_digests)).hexdigest() + f"-{len(part_numbers)}"
        now = int(time.time())
        self.client.create_entry(
            self._object_path(bucket, key),
            {
                "mime": info.get("extended", {}).get("content-type", ""),
                "chunks": chunks,
                "extended": {"md5": etag},
                "mtime": now,
                "crtime": now,
            },
        )
        # parts not referenced by the Complete request would otherwise leak
        # their chunks — purge them explicitly first (legacy 04d names are
        # wanted too, so an upgraded-mid-upload part isn't double-purged)
        wanted = {f"{p:05d}.part" for p in part_numbers} | {
            f"{p:04d}.part" for p in part_numbers
        }
        stale = [
            e["name"]
            for e in self.client.list(f"{UPLOADS_DIR}/{upload_id}", limit=10001)
            if e["name"].endswith(".part") and e["name"] not in wanted
        ]
        if stale:
            # each delete purges that part's chunks on the volumes — slow,
            # independent round-trips, so run them under a bounded window
            pipe = BoundedExecutor(window=8, name="s3-purge")
            for name in stale:
                pipe.submit(
                    self.client.delete, f"{UPLOADS_DIR}/{upload_id}/{name}"
                )
            pipe.drain()
        # referenced parts' meta goes away; their chunks now belong to the
        # target entry
        self.client.delete(
            f"{UPLOADS_DIR}/{upload_id}", recursive=True, skip_chunk_purge=True
        )
        return 200, to_xml(
            "CompleteMultipartUploadResult",
            {
                "Location": f"/{bucket}/{key}",
                "Bucket": bucket,
                "Key": key,
                "ETag": f'"{etag}"',
            },
        )

    def _abort_multipart(self, bucket, key, q):
        upload_id = q["uploadId"]
        self.client.delete(f"{UPLOADS_DIR}/{upload_id}", recursive=True)
        return 204, b""

    def _list_parts(self, bucket, key, q):
        upload_id = q["uploadId"]
        if self.client.get_entry(f"{UPLOADS_DIR}/{upload_id}/.info") is None:
            return _err("NoSuchUpload", upload_id)
        parts = []
        for e in self.client.list(f"{UPLOADS_DIR}/{upload_id}", limit=10001):
            if not e["name"].endswith(".part"):
                continue
            size = max(
                (c["offset"] + c["size"] for c in e.get("chunks", [])), default=0
            )
            parts.append(
                {
                    "PartNumber": int(e["name"].split(".")[0]),
                    "LastModified": _iso(e.get("mtime", 0)),
                    "ETag": f'"{e.get("extended", {}).get("md5", "")}"',
                    "Size": size,
                }
            )
        return 200, to_xml(
            "ListPartsResult",
            {
                "Bucket": bucket,
                "Key": key,
                "UploadId": upload_id,
                "Part": parts,
            },
        )

    def _list_uploads(self, bucket):
        uploads = []
        for e in self.client.list(UPLOADS_DIR, limit=10000):
            if not e.get("is_directory"):
                continue
            info = self.client.get_entry(f"{UPLOADS_DIR}/{e['name']}/.info")
            if info and info.get("extended", {}).get("bucket") == bucket:
                uploads.append(
                    {
                        "Key": info["extended"].get("key", ""),
                        "UploadId": e["name"],
                        "Initiated": _iso(e.get("crtime", 0)),
                    }
                )
        return 200, to_xml(
            "ListMultipartUploadsResult",
            {"Bucket": bucket, "Upload": uploads},
        )

    # -------------------------------------------------------- post-policy
    def _post_policy_upload(self, bucket, headers, body):
        """Browser form upload with a signed policy
        (s3api_object_handlers_postpolicy.go:20). Auth lives inside the
        form, not the request headers."""
        try:
            values, file_bytes, file_name = pp.parse_multipart_form(
                body, headers.get("Content-Type", "")
            )
        except (ValueError, FileNotFoundError) as e:
            return _err("MalformedPOSTRequest", f"/{bucket}", str(e))
        values["bucket"] = bucket
        key = values.get("key", "")
        if not key:
            return _err("MalformedPOSTRequest", f"/{bucket}", "no key field")
        if "${filename}" in key:
            key = key.replace("${filename}", file_name)
            values["key"] = key
        if has_dot_segments(key):
            # same guard the PUT path applies in handle(): the filer will
            # refuse the write, so answer the client's 400 shape here
            # instead of wrapping the filer's
            return _err("InvalidArgument", f"/{bucket}/{key}",
                        "key must not contain '.' or '..' path segments")

        identity = None
        access_key = ""
        signed = (
            "signature" in values
            or "x-amz-signature" in values
            or values.get("policy")
        )
        if self.iam.enabled and signed:
            def secret_for(ak):
                ident = self.iam._by_key.get(ak)
                return ident.secret_key if ident else None

            if "signature" in values:  # SignV2 form
                ak = pp.verify_policy_signature_v2(values, secret_for)
            else:
                ak = pp.verify_policy_signature_v4(values, secret_for)
            if ak is None:
                return _err("SignatureDoesNotMatch", f"/{bucket}/{key}")
            identity = self.iam._by_key[ak]
            access_key = ak
        # the bucket policy governs form POSTs too: explicit Deny wins on
        # every write path, and an Allow admits principals (incl. anonymous)
        # beyond their identity grant list
        pol = self._bucket_policy(bucket)
        verdict = None
        if pol is not None:
            verdict = pe.evaluate(
                pol, access_key, "s3:PutObject", pe.arn(bucket, key)
            )
        if verdict is False:
            return _err("AccessDenied", f"/{bucket}/{key}")
        if self.iam.enabled and verdict is not True:
            if identity is None:  # unsigned form, no policy Allow
                return _err("AccessDenied", f"/{bucket}/{key}")
            if not identity.can_do(s3auth.ACTION_WRITE, bucket):
                return _err("AccessDenied", f"/{bucket}/{key}")
        if values.get("policy"):
            try:
                policy = pp.parse_post_policy(pp.decode_policy(values))
                pp.check_post_policy(values, policy)
            except ValueError as e:
                return _err(
                    "PostPolicyInvalidCondition", f"/{bucket}/{key}", str(e)
                )
            if policy.length_min >= 0 and len(file_bytes) < policy.length_min:
                return _err("EntityTooSmall", f"/{bucket}/{key}")
            if 0 <= policy.length_max < len(file_bytes):
                return _err("EntityTooLarge", f"/{bucket}/{key}")
        elif identity is not None:
            # authenticated posts must carry a policy (the signature signs it)
            return _err("MalformedPOSTRequest", f"/{bucket}/{key}", "no policy")

        ctype = values.get("content-type", "application/octet-stream")
        res = self._put_object(
            bucket, key, {"Content-Type": ctype}, file_bytes
        )
        status = res[0]
        if status not in (200, 201):
            return res
        # advertise the same ETag a later GET/HEAD will serve
        etag = (res[2].get("ETag", "") if len(res) == 3 else "").strip('"')
        etag = etag or hashlib.md5(file_bytes).hexdigest()
        redirect = values.get("success_action_redirect", "")
        if redirect:
            sep = "&" if "?" in redirect else "?"
            loc = f"{redirect}{sep}bucket={bucket}&key=" + urllib.parse.quote(
                key
            ) + f"&etag=%22{etag}%22"
            return 303, b"", {"Location": loc}
        want_status = values.get("success_action_status", "204")
        if want_status == "201":
            return 201, to_xml(
                "PostResponse",
                {
                    "Location": f"/{bucket}/{key}",
                    "Bucket": bucket,
                    "Key": key,
                    "ETag": f'"{etag}"',
                },
            )
        return (200, b"") if want_status == "200" else (204, b"")

    # -------------------------------------------------------- bucket policy
    # Stored under /etc (like the reference's s3 config subtree), NOT under
    # /buckets — a policy document must never be addressable as an object,
    # or a plain Write grant could rewrite any bucket's policy.
    POLICIES_DIR = "/etc/s3/policies"

    def _bucket_policy(self, bucket):
        """Cached parse of the bucket's policy document (None = no policy)."""
        with self._policy_lock:
            cached = self._policy_cache.get(bucket)
            gen = self._policy_gen.get(bucket, 0)
        if cached is not None:
            return cached[0]
        status, data, _ = self.client.get_object(
            f"{self.POLICIES_DIR}/{bucket}"
        )
        pol = None
        if status == 200 and data:
            try:
                pol = pe.parse_bucket_policy(data)
            except (ValueError, KeyError):
                pol = None
        with self._policy_lock:
            if self._policy_gen.get(bucket, 0) != gen:
                return pol  # invalidated mid-read: serve but don't cache
            while len(self._policy_cache) >= 1024:  # bound negative entries
                self._policy_cache.pop(next(iter(self._policy_cache)))
            self._policy_cache[bucket] = (pol,)
        return pol

    def _put_bucket_policy(self, bucket, body):
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        try:
            pe.parse_bucket_policy(body)
        except (ValueError, KeyError) as e:
            return _err("MalformedPolicy", bucket, str(e))
        self.client.put_object(f"{self.POLICIES_DIR}/{bucket}", body)
        with self._policy_lock:
            self._policy_gen[bucket] = self._policy_gen.get(bucket, 0) + 1
            self._policy_cache.pop(bucket, None)
        return 204, b""

    def _get_bucket_policy(self, bucket):
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        status, data, _ = self.client.get_object(
            f"{self.POLICIES_DIR}/{bucket}"
        )
        if status != 200 or not data:
            return _err("NoSuchBucketPolicy", bucket)
        return 200, data, {"Content-Type": "application/json"}

    def _delete_bucket_policy(self, bucket):
        if not self._bucket_exists(bucket):
            return _err("NoSuchBucket", bucket)
        self.client.delete(f"{self.POLICIES_DIR}/{bucket}")
        with self._policy_lock:
            self._policy_gen[bucket] = self._policy_gen.get(bucket, 0) + 1
            self._policy_cache.pop(bucket, None)
        return 204, b""

    # ------------------------------------------------------------------ router
    def handle(self, method, raw_path, query, headers, body):
        path_probe = urllib.parse.unquote(raw_path).lstrip("/")
        if (
            method == "POST"
            and path_probe
            and not path_probe.startswith(".")
            and "/" not in path_probe.rstrip("/")
            and headers.get("Content-Type", "").startswith(
                "multipart/form-data"
            )
        ):
            # bucket-level form POST: auth is in the form, not the headers
            # (s3api_server.go:101 routes these before the auth wrapper)
            return self._post_policy_upload(
                path_probe.rstrip("/"), headers, body
            )
        identity, err = self.iam.authenticate(
            method, raw_path, query, headers, body
        )
        # an unsigned request is not an auth *failure* — it falls through as
        # anonymous so a bucket policy with Principal "*" can admit it
        # (public buckets). Bad signatures still hard-fail.
        anonymous = (
            err == "AccessDenied"
            and not headers.get("Authorization")
            and "X-Amz-Algorithm" not in query
            and "Signature" not in query
        )
        if err and not anonymous:
            return _err(err, raw_path)
        path = urllib.parse.unquote(raw_path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0] if parts[0] else ""
        key = parts[1] if len(parts) > 1 else ""
        if bucket.startswith("."):
            # dot-prefixed names would collide with the gateway's internal
            # dirs under /buckets (.uploads); S3 names start alphanumeric
            return _err("InvalidBucketName", path)
        if method in ("PUT", "POST") and has_dot_segments(key):
            # keys are filer paths here: the filer refuses literal "."/".."
            # segments on writes (unrepresentable through the FUSE mount),
            # so answer the client's error shape instead of wrapping the
            # filer's 400. GET/DELETE stay literal — pre-existing artifacts
            # remain readable and deletable so buckets can be emptied.
            return _err("InvalidArgument", path,
                        "key must not contain '.' or '..' path segments")

        def allowed(action, s3_action="", obj_key=None):
            # resource policy first (explicit Deny wins, Allow grants even
            # beyond the identity grant list), then identity grants.
            # s3_action picks the exact policy action name when the coarse
            # gate is ambiguous (s3:DeleteObject vs s3:PutObject, …).
            if bucket:
                pol = self._bucket_policy(bucket)
                if pol is not None:
                    who = identity.access_key if identity else ""
                    name = s3_action or pe.ACTION_NAMES.get(action, "s3:*")
                    k = key if obj_key is None else obj_key
                    res = pe.arn(bucket, k) if k else pe.arn(bucket)
                    verdict = pe.evaluate(pol, who, name, res)
                    if verdict is not None:
                        return verdict
            if anonymous:
                return False  # only an explicit policy Allow admits anonymous
            return identity is None or identity.can_do(action, bucket)

        src_hdr = headers.get("X-Amz-Copy-Source", "")
        if src_hdr and method == "PUT":
            # copy sources are an independent READ of another resource: the
            # destination-bucket write grant must not leak other tenants'
            # bytes (or gateway-internal dirs like .uploads) through a copy
            sb, sk = _parse_copy_source(src_hdr)
            if not sb or not sk or sb.startswith("."):
                return _err("InvalidCopySource", path)
            src_pol = self._bucket_policy(sb)
            verdict = None
            if src_pol is not None:
                verdict = pe.evaluate(
                    src_pol,
                    identity.access_key if identity else "",
                    "s3:GetObject",
                    pe.arn(sb, sk),
                )
            if verdict is None:
                verdict = (
                    not anonymous
                    and (
                        identity is None
                        or identity.can_do(s3auth.ACTION_READ, sb)
                    )
                )
            if not verdict:
                return _err("AccessDenied", path)

        # ?policy subresource (PutBucketPolicy / GetBucketPolicy / Delete)
        if bucket and not key and "policy" in query:
            if self.iam.enabled and (
                identity is None
                or not identity.can_do(s3auth.ACTION_ADMIN, bucket)
            ):
                return _err("AccessDenied", path)
            if method == "PUT":
                return self._put_bucket_policy(bucket, body)
            if method == "GET":
                return self._get_bucket_policy(bucket)
            if method == "DELETE":
                return self._delete_bucket_policy(bucket)

        if not bucket:
            if method == "GET":
                if not allowed(s3auth.ACTION_LIST):
                    return _err("AccessDenied", path)
                return self._list_buckets(identity)
            return _err("MethodNotAllowed", path)

        if not key:
            if method == "PUT":
                if "acl" in query:
                    if not allowed(s3auth.ACTION_ADMIN):
                        return _err("AccessDenied", path)
                    if not self._bucket_exists(bucket):
                        return _err("NoSuchBucket", bucket)
                    return 200, b""  # accepted no-op, like GET ?acl's canned view
                if not allowed(s3auth.ACTION_ADMIN, "s3:CreateBucket"):
                    return _err("AccessDenied", path)
                return self._put_bucket(bucket)
            if method == "HEAD":
                if not allowed(s3auth.ACTION_READ, "s3:ListBucket"):
                    return _err("AccessDenied", path)
                return self._head_bucket(bucket)
            if method == "DELETE":
                if not allowed(s3auth.ACTION_ADMIN, "s3:DeleteBucket"):
                    return _err("AccessDenied", path)
                return self._delete_bucket(bucket)
            if method == "POST" and "delete" in query:
                # per-key policy evaluation — an object-scoped Deny must
                # cover the batch path exactly like single DELETEs
                return self._delete_multiple(
                    bucket,
                    body,
                    can_delete=lambda k: allowed(
                        s3auth.ACTION_WRITE, "s3:DeleteObject", obj_key=k
                    ),
                )
            if method == "GET":
                if not allowed(s3auth.ACTION_LIST):
                    return _err("AccessDenied", path)
                if "acl" in query:
                    return self._get_acl(bucket)
                if "uploads" in query:
                    return self._list_uploads(bucket)
                if "location" in query:
                    return 200, to_xml("LocationConstraint", "")
                return self._list_objects(
                    bucket, query, v2=query.get("list-type") == "2"
                )
            return _err("MethodNotAllowed", path)

        # object-level
        if "tagging" in query:
            tag_action = {
                "GET": "s3:GetObjectTagging",
                "PUT": "s3:PutObjectTagging",
                "DELETE": "s3:DeleteObjectTagging",
            }.get(method, "s3:PutObjectTagging")
            if not allowed(s3auth.ACTION_TAGGING, tag_action):
                return _err("AccessDenied", path)
            if method == "GET":
                return self._get_tagging(bucket, key)
            if method == "PUT":
                return self._put_tagging(bucket, key, body)
            if method == "DELETE":
                return self._delete_tagging(bucket, key)
        if method == "POST" and "select" in query:
            # SelectObjectContent reads object content: gate exactly like
            # a GET of the same key
            if not allowed(s3auth.ACTION_READ, "s3:GetObject"):
                return _err("AccessDenied", path)
            return self._select_object(bucket, key, query, body)
        if method == "POST" and "uploads" in query:
            if not allowed(s3auth.ACTION_WRITE):
                return _err("AccessDenied", path)
            return self._initiate_multipart(bucket, key, headers)
        if method == "POST" and "uploadId" in query:
            if not allowed(s3auth.ACTION_WRITE):
                return _err("AccessDenied", path)
            return self._complete_multipart(bucket, key, query, body)
        if method == "PUT" and "uploadId" in query:
            if not allowed(s3auth.ACTION_WRITE):
                return _err("AccessDenied", path)
            return self._upload_part(bucket, key, query, body, headers)
        if method == "DELETE" and "uploadId" in query:
            if not allowed(s3auth.ACTION_WRITE, "s3:AbortMultipartUpload"):
                return _err("AccessDenied", path)
            return self._abort_multipart(bucket, key, query)
        if method == "GET" and "uploadId" in query:
            if not allowed(s3auth.ACTION_READ, "s3:ListMultipartUploadParts"):
                return _err("AccessDenied", path)
            return self._list_parts(bucket, key, query)
        if "acl" in query:
            # GET serves the canned owner view; PUT is an accepted no-op —
            # either falling through would corrupt the object (PUT would
            # store the ACL XML as the object body)
            if method == "GET":
                if not allowed(s3auth.ACTION_READ):
                    return _err("AccessDenied", path)
                return self._get_acl(bucket, key)
            if method == "PUT":
                if not allowed(s3auth.ACTION_WRITE):
                    return _err("AccessDenied", path)
                entry = self.client.get_entry(self._object_path(bucket, key))
                if entry is None or entry.get("is_directory"):
                    return _err("NoSuchKey", key)
                return 200, b""
            return _err("MethodNotAllowed", path)
        if method == "PUT":
            if not allowed(s3auth.ACTION_WRITE):
                return _err("AccessDenied", path)
            return self._put_object(bucket, key, headers, body)
        if method in ("GET", "HEAD"):
            if not allowed(s3auth.ACTION_READ):
                return _err("AccessDenied", path)
            return self._get_object(bucket, key, headers, head=(method == "HEAD"))
        if method == "DELETE":
            if not allowed(s3auth.ACTION_WRITE, "s3:DeleteObject"):
                return _err("AccessDenied", path)
            return self._delete_object(bucket, key)
        return _err("MethodNotAllowed", path)

    # --------------------------------------------------------------- lifecycle
    def start(self):
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # keep-alive + Nagle = ~40ms RTTs
            trace_service = "s3"
            # hot GetObject served natively on the loop (aio mode); every
            # edge falls back to the bridged _go path for canonical bytes
            native_routes = [("GET", "/", api._get_object_native)]

            def log_message(self, fmt, *args):
                pass

            def _go(self, method):
                parsed = urllib.parse.urlparse(self.path)
                query = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                length = parse_content_length(self.headers)
                if length < 0:
                    # framing is unknowable → 400 and drop the connection
                    self.close_connection = True
                    data = error_xml(
                        "IncompleteBody", "bad Content-Length", parsed.path
                    )
                    self.send_response(400)
                    self.send_header("Content-Type", "application/xml")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                headers = {k.title(): v for k, v in self.headers.items()}
                # stream-eligible object PUT: auth never needs the bytes
                # (unsigned/absent payload hash) and no sub-resource is
                # addressed, so the body can flow straight to the filer
                sha = headers.get("X-Amz-Content-Sha256", "")
                reader = None
                if (
                    method == "PUT"
                    and length > 0
                    and sha in ("", s3auth.UNSIGNED_PAYLOAD)
                    and not query
                    and "X-Amz-Copy-Source" not in headers
                    # a real /bucket/key — '/bucket' and '/bucket/' are
                    # bucket ops whose handlers never consume a body
                    and parsed.path.rstrip("/").count("/") >= 2
                ):
                    reader = CountedReader(self.rfile, length)
                    body = (reader, length)
                else:
                    body = self.rfile.read(length) if length else b""
                # span + latency classification: bucket vs object op keeps
                # the label space bounded (full path rides the span tag)
                p = parsed.path.strip("/")
                kind = "object" if "/" in p else ("bucket" if p else "service")
                with _trace.start_span(
                    f"{method} s3:{kind}",
                    service="s3",
                    parent_header=headers.get(_trace.TRACE_HEADER),
                    path=parsed.path,
                ) as span, api._req_hist.time(op=f"{kind}_{method.lower()}"):
                    try:
                        result = api.handle(
                            method, parsed.path, query, headers, body
                        )
                    except Exception as e:  # noqa: BLE001
                        result = 500, error_xml(
                            "InternalError", str(e), parsed.path
                        )
                    if reader is not None and reader.left > 0:
                        # refused before the body was consumed: bounded,
                        # timeout-guarded drain (http_util.drain_refused_body)
                        drain_refused_body(self, reader)
                    if len(result) == 2:
                        status, payload = result
                        extra = {}
                    else:
                        status, payload, extra = result
                    if span is not None:
                        span.tags["status"] = status
                        if status >= 500:
                            span.status = "error"
                        extra.setdefault(_trace.TRACE_ID_HEADER, span.trace_id)
                    self.send_response(status)
                    streaming = hasattr(payload, "read")
                    clen = extra.pop("Content-Length-Override", None)
                    ctype = extra.pop(
                        "Content-Type",
                        "application/xml"
                        if payload
                        else "application/octet-stream",
                    )
                    self.send_header("Content-Type", ctype)
                    if streaming:
                        self.send_header("Content-Length", clen)  # always set
                    else:
                        self.send_header(
                            "Content-Length", clen or str(len(payload))
                        )
                    for k, v in extra.items():
                        self.send_header(k, v)
                    self.end_headers()
                    if streaming:
                        if method == "HEAD":
                            payload.close()
                        else:
                            relay_stream(self, payload, int(clen))
                    elif method != "HEAD" and payload:
                        self.wfile.write(payload)

            def do_GET(self):
                self._go("GET")

            def do_PUT(self):
                self._go("PUT")

            def do_POST(self):
                self._go("POST")

            def do_DELETE(self):
                self._go("DELETE")

            def do_HEAD(self):
                self._go("HEAD")

        from ..security.tls import optional_server_context

        ctx = optional_server_context(*self._tls)
        self._srv = start_server(Handler, self.host, self.port, ssl_context=ctx)
        return self

    def stop(self):
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"


def _err(code: str, resource: str, message: str = ""):
    status = _ERR_STATUS.get(code, 400)
    return status, error_xml(code, message or code, resource)
