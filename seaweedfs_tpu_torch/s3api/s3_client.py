"""Minimal S3 client with AWS SigV4 signing: what the remote tier uploads,
ranges and deletes with, and what drives the S3 gateway (presigned URLs,
streaming aws-chunked uploads, listings, SelectObjectContent).

The signing is an independent implementation of the SigV4 spec (canonical
request, string to sign, HMAC chain), the JAX package's byte for byte: on
the same inputs and the same clock both clients sign the same.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone
from typing import Optional

from ..server.http_util import http_bytes_headers
from ..util.parsers import tolerant_uint
from .xml_util import find_text, parse_xml, to_xml

_SAFE_PATH = "/~-._"
_SAFE_QUERY = "~-._"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret_key: str, datestamp: str, region: str) -> bytes:
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    return _hmac(_hmac(_hmac(k, region), "s3"), "aws4_request")


def _canonical_query(query: dict) -> str:
    return "&".join(
        urllib.parse.quote(k, safe=_SAFE_QUERY) + "=" + urllib.parse.quote(str(v), safe=_SAFE_QUERY)
        for k, v in sorted(query.items()))


class S3Client:
    def __init__(self, endpoint: str, access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", ssl_context=None):
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        # https endpoints: a pinned CA and/or client certificate; None takes
        # the system's defaults (and is unused for http)
        self.ssl_context = ssl_context

    # -- SigV4 ---------------------------------------------------------------
    def _sign(self, method: str, path: str, query: dict, headers: dict, body: bytes) -> dict:
        if not self.access_key:
            return headers
        now = datetime.now(tz=timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = dict(headers)
        # a caller may set the payload hash (or its marker) itself
        payload_hash = headers.get("X-Amz-Content-Sha256", hashlib.sha256(body).hexdigest())
        headers["Host"] = urllib.parse.urlparse(self.endpoint).netloc
        headers["X-Amz-Date"] = amz_date
        headers["X-Amz-Content-Sha256"] = payload_hash
        signed = sorted(k.lower() for k in headers)
        canonical_headers = "".join(
            f"{k}:{' '.join(str(headers[h]).split())}\n"
            for k, h in sorted((k.lower(), k) for k in headers))
        canonical = "\n".join([
            method, urllib.parse.quote(path, safe=_SAFE_PATH), _canonical_query(query),
            canonical_headers, ";".join(signed), payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
        key = _signing_key(self.secret_key, datestamp, self.region)
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return headers

    def presign(self, method: str, path: str, expires: int = 3600) -> str:
        """A presigned URL (query-string auth, unsigned payload)."""
        now = datetime.now(tz=timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        canonical_query = _canonical_query({
            "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
            "X-Amz-Credential": f"{self.access_key}/{scope}",
            "X-Amz-Date": amz_date,
            "X-Amz-Expires": str(expires),
            "X-Amz-SignedHeaders": "host",
        })
        canonical = "\n".join([
            method, urllib.parse.quote(path, safe=_SAFE_PATH), canonical_query,
            f"host:{host}\n", "host", "UNSIGNED-PAYLOAD"])
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
        key = _signing_key(self.secret_key, datestamp, self.region)
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        return (f"{self.endpoint}{urllib.parse.quote(path, safe=_SAFE_PATH)}"
                f"?{canonical_query}&X-Amz-Signature={sig}")

    # -- transport -----------------------------------------------------------
    def _send(self, method: str, url: str, body: bytes, headers: dict) -> tuple[int, bytes, dict]:
        if url.startswith("http://"):
            # plain http rides the pooled keep-alive transport
            return http_bytes_headers(method, url, body=body or None, timeout=30,
                                      headers=headers)
        req = urllib.request.Request(url, data=body or None, method=method, headers=headers)
        try:
            # sweedlint: ok deadline-not-propagated remote-S3 egress; a signed third-party request must not carry the internal deadline header
            with urllib.request.urlopen(req, timeout=30, context=self.ssl_context) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def request(self, method: str, path: str, query: Optional[dict] = None,
                body: bytes = b"", headers: Optional[dict] = None) -> tuple[int, bytes, dict]:
        query = query or {}
        headers = self._sign(method, path, query, headers or {}, body)
        qs = urllib.parse.urlencode(query)
        url = self.endpoint + urllib.parse.quote(path, safe=_SAFE_PATH) + ("?" + qs if qs else "")
        return self._send(method, url, body, headers)

    def put_object_streaming(self, bucket: str, key: str,
                             chunks: list[bytes]) -> tuple[int, bytes, dict]:
        """A streaming SigV4 upload: the aws-chunked framing, with the
        per-chunk signature chain seeded by the header's signature."""
        path = f"/{bucket}/{key}"
        total = sum(len(c) for c in chunks)
        headers = self._sign("PUT", path, {}, {
            "X-Amz-Content-Sha256": "STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
            "X-Amz-Decoded-Content-Length": str(total),
        }, b"")
        auth = headers["Authorization"]
        prev = auth.rsplit("Signature=", 1)[1]
        scope = auth.split("Credential=")[1].split(",")[0].split("/", 1)[1]
        date, region = scope.split("/")[:2]
        key_b = _signing_key(self.secret_key, date, region)
        empty = hashlib.sha256(b"").hexdigest()
        framed = bytearray()
        for c in list(chunks) + [b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", headers["X-Amz-Date"], scope,
                             prev, empty, hashlib.sha256(c).hexdigest()])
            prev = hmac.new(key_b, sts.encode(), hashlib.sha256).hexdigest()
            framed += f"{len(c):x};chunk-signature={prev}\r\n".encode()
            framed += c + b"\r\n"
        url = self.endpoint + urllib.parse.quote(path, safe=_SAFE_PATH)
        return self._send("PUT", url, bytes(framed), headers)

    # -- multipart upload: large objects with bounded memory ----------------
    def initiate_multipart(self, bucket: str, key: str) -> str:
        status, body, _ = self.request("POST", f"/{bucket}/{key}", query={"uploads": ""})
        if status != 200:
            raise RuntimeError(f"initiate multipart: HTTP {status}")
        upload_id = find_text(parse_xml(body), "UploadId")
        if not upload_id:
            raise RuntimeError("initiate multipart: no UploadId in response")
        return upload_id

    def upload_part(self, bucket: str, key: str, upload_id: str, part_number: int,
                    body: bytes) -> str:
        status, _, headers = self.request(
            "PUT", f"/{bucket}/{key}",
            query={"partNumber": str(part_number), "uploadId": upload_id}, body=body)
        if status != 200:
            raise RuntimeError(f"upload part {part_number}: HTTP {status}")
        return headers.get("ETag", headers.get("Etag", "")).strip('"')

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: list[tuple[int, str]]):
        body = to_xml("CompleteMultipartUpload",
                      {"Part": [{"PartNumber": num, "ETag": etag} for num, etag in parts]},
                      xmlns="")
        return self.request("POST", f"/{bucket}/{key}", query={"uploadId": upload_id},
                            body=body)

    def abort_multipart(self, bucket: str, key: str, upload_id: str):
        return self.request("DELETE", f"/{bucket}/{key}", query={"uploadId": upload_id})

    def put_object_from_file(self, bucket: str, key: str, path: str,
                             part_bytes: int = 64 * 1024 * 1024) -> int:
        """Upload a file of any size with bounded memory: one PUT when it
        fits one part, multipart otherwise. Returns the final HTTP status."""
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size <= part_bytes:
                status, _, _ = self.put_object(bucket, key, f.read())
                return status
            upload_id = self.initiate_multipart(bucket, key)
            try:
                parts: list[tuple[int, str]] = []
                while chunk := f.read(part_bytes):
                    num = len(parts) + 1
                    parts.append((num, self.upload_part(bucket, key, upload_id, num, chunk)))
                status, _, _ = self.complete_multipart(bucket, key, upload_id, parts)
                return status
            except Exception:
                # strand no uploaded parts on the backend
                try:
                    self.abort_multipart(bucket, key, upload_id)
                # sweedlint: ok broad-except best-effort abort; the complete error re-raises below
                except Exception:  # noqa: BLE001 — the upload's own error re-raises below
                    pass
                raise

    def get_object_to_file(self, bucket: str, key: str, path: str,
                           part_bytes: int = 64 * 1024 * 1024) -> int:
        """Ranged-GET download with bounded memory; returns the bytes."""
        status, _, headers = self.head_object(bucket, key)
        if status != 200:
            raise RuntimeError(f"head before ranged get: HTTP {status}")
        size = tolerant_uint(headers.get("Content-Length", 0), 0)
        total = 0
        with open(path, "wb") as f:
            while total < size:
                end = min(total + part_bytes, size) - 1
                status, data, _ = self.get_object(bucket, key, rng=f"bytes={total}-{end}")
                if status not in (200, 206) or not data:
                    raise RuntimeError(f"ranged get at {total}: HTTP {status}")
                f.write(data)
                total += len(data)
        return total

    # -- single-request verbs ------------------------------------------------
    def create_bucket(self, bucket: str):
        return self.request("PUT", f"/{bucket}")

    def delete_bucket(self, bucket: str):
        return self.request("DELETE", f"/{bucket}")

    def list_buckets(self):
        return self.request("GET", "/")

    def put_object(self, bucket: str, key: str, body: bytes, **headers):
        return self.request("PUT", f"/{bucket}/{key}", body=body, headers=headers)

    def get_object(self, bucket: str, key: str, rng: str = ""):
        return self.request("GET", f"/{bucket}/{key}", headers={"Range": rng} if rng else {})

    def head_object(self, bucket: str, key: str):
        return self.request("HEAD", f"/{bucket}/{key}")

    def delete_object(self, bucket: str, key: str):
        return self.request("DELETE", f"/{bucket}/{key}")

    def list_objects(self, bucket: str, v2: bool = False, **params):
        if v2:
            params["list-type"] = "2"
        return self.request("GET", f"/{bucket}", query=params)

    def select_object_content(self, bucket: str, key: str, expression: str,
                              input_format: str = "csv", compression: str = "NONE",
                              output_format: str = "",
                              request_progress: bool = False) -> tuple[bytes, dict]:
        """SelectObjectContent: ``POST ?select&select-type=2``, the event
        stream decoded (CRCs checked) into (records' bytes, stats). An S3
        error raises IOError naming its code."""
        in_ser: dict = {"CompressionType": compression}
        if input_format == "csv":
            in_ser["CSV"] = {"FileHeaderInfo": "USE"}
        else:
            in_ser["JSON"] = {"Type": "LINES"}
        out_fmt = output_format or input_format
        req: dict = {
            "Expression": expression,
            "ExpressionType": "SQL",
            "InputSerialization": in_ser,
            "OutputSerialization": {"CSV": {}} if out_fmt == "csv" else {"JSON": {}},
        }
        if request_progress:
            req["RequestProgress"] = {"Enabled": True}
        status, data, _ = self.request(
            "POST", f"/{bucket}/{key}", query={"select": "", "select-type": "2"},
            body=to_xml("SelectObjectContentRequest", req, xmlns=""),
            headers={"Content-Type": "application/xml"})
        if status != 200:
            code = find_text(parse_xml(data), "Code", "InternalError")
            raise IOError(f"select {bucket}/{key}: {code} (HTTP {status})")
        # imported here: the query package loads torch, which the client's
        # other users (the cold tier under every Volume, the offline tools)
        # do not need
        from ..query.select import iter_events

        records, stats = [], {}
        for ev in iter_events(data):
            etype = ev["headers"].get(":event-type", "")
            if etype == "Records":
                records.append(ev["payload"])
            elif etype == "Stats":
                sx = parse_xml(ev["payload"])
                stats = {t: tolerant_uint(find_text(sx, t, "0"), 0)
                         for t in ("BytesScanned", "BytesProcessed", "BytesReturned")}
        return b"".join(records), stats
