"""AWS signature authentication for the S3 gateway.

Implements the subset the reference ships (`weed/s3api/auth_credentials.go:124`,
`auth_signature_v4.go`, `auth_signature_v2.go`, `chunked_reader_v4.go`):

- Signature V4: `Authorization` header, presigned query (`X-Amz-Signature`),
  and streaming uploads (`STREAMING-AWS4-HMAC-SHA256-PAYLOAD`) whose body is
  the aws-chunked framing with a per-chunk signature chain.
- Signature V2: `Authorization: AWS key:sig` and presigned (`?Signature=`).
- Identities with per-action grants: Admin, Read, Write, List, Tagging —
  optionally scoped `Action:bucket` (`auth_credentials.go` Identity.canDo).

When no identities are configured every request is allowed (the reference's
"not enabled" mode).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time as _time
import urllib.parse
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional

from ..util.parsers import parse_ascii_uint

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"

# s3err codes the handlers map to HTTP statuses
ERR_NONE = None
ERR_ACCESS_DENIED = "AccessDenied"
ERR_INVALID_ACCESS_KEY = "InvalidAccessKeyId"
ERR_SIGNATURE_MISMATCH = "SignatureDoesNotMatch"
ERR_MISSING_FIELDS = "MissingFields"
ERR_EXPIRED_REQUEST = "ExpiredPresignRequest"
# malformed presign query values (non-numeric X-Amz-Expires etc.) are the
# client's error: AWS answers 400 AuthorizationQueryParametersError, and
# anything else here either coerces ('+5' parsed as 5) or turns into a 500
ERR_MALFORMED_QUERY = "AuthorizationQueryParametersError"
# the reference's ErrRequestNotReadyYet serializes as code "AccessDenied"
# with 403 (s3api_errors.go:317-321) — a URL dated in the future is not
# "expired", it has not begun its validity window
ERR_REQUEST_NOT_READY = "AccessDenied"


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=list)

    def can_do(self, action: str, bucket: str = "") -> bool:
        if ACTION_ADMIN in self.actions:
            return True
        if action in self.actions:
            return True
        return bucket and f"{action}:{bucket}" in self.actions


class IAM:
    """Identity registry + request authentication (auth_credentials.go)."""

    def __init__(self, identities: Optional[list[Identity]] = None):
        self.identities = identities or []
        self._by_key = {i.access_key: i for i in self.identities}

    @classmethod
    def from_config(cls, conf: dict) -> "IAM":
        """Accepts the reference's s3.json shape: {"identities": [{"name":...,
        "credentials": [{"accessKey":..., "secretKey":...}], "actions":[...]}]}"""
        ids = []
        for d in conf.get("identities", []):
            for cred in d.get("credentials", [{}]):
                ids.append(
                    Identity(
                        name=d.get("name", ""),
                        access_key=cred.get("accessKey", ""),
                        secret_key=cred.get("secretKey", ""),
                        actions=list(d.get("actions", [])),
                    )
                )
        return cls(ids)

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    # -- entry point ----------------------------------------------------------
    def authenticate(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[Optional[Identity], Optional[str]]:
        """Returns (identity, error_code). identity None + error None means
        anonymous allowed (auth disabled)."""
        if not self.enabled:
            return None, ERR_NONE
        auth = headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256"):
            return self._check_v4_header(method, path, query, headers, body, auth)
        if auth.startswith("AWS "):
            return self._check_v2_header(method, path, query, headers, auth)
        if query.get("X-Amz-Algorithm") == "AWS4-HMAC-SHA256":
            return self._check_v4_presigned(method, path, query, headers)
        if "Signature" in query and "AWSAccessKeyId" in query:
            return self._check_v2_presigned(method, path, query)
        return None, ERR_ACCESS_DENIED

    # -- v4 -------------------------------------------------------------------
    @staticmethod
    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    @classmethod
    def signing_key(cls, secret: str, date: str, region: str, service: str) -> bytes:
        k = cls._hmac(("AWS4" + secret).encode(), date)
        k = cls._hmac(k, region)
        k = cls._hmac(k, service)
        return cls._hmac(k, "aws4_request")

    @staticmethod
    def _canonical_uri(path: str) -> str:
        # the wire-format (already percent-encoded) path is the canonical URI
        # for S3; re-encoding would break real clients (boto signs the
        # encoded form once)
        return path or "/"

    @staticmethod
    def _canonical_query(query: dict[str, str], skip: tuple = ()) -> str:
        parts = []
        for k in sorted(query):
            if k in skip:
                continue
            parts.append(
                urllib.parse.quote(k, safe="~-._")
                + "="
                + urllib.parse.quote(query[k], safe="~-._")
            )
        return "&".join(parts)

    @staticmethod
    def _canonical_headers(
        headers: dict[str, str], signed: list[str]
    ) -> str:
        low = {k.lower(): v for k, v in headers.items()}
        return "".join(
            f"{h}:{' '.join(low.get(h, '').split())}\n" for h in signed
        )

    def _v4_signature(
        self,
        secret: str,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        signed_headers: list[str],
        payload_hash: str,
        amz_date: str,
        scope: str,
        skip_q: tuple = (),
    ) -> str:
        canonical = "\n".join(
            [
                method,
                self._canonical_uri(path),
                self._canonical_query(query, skip=skip_q),
                self._canonical_headers(headers, signed_headers),
                ";".join(signed_headers),
                payload_hash,
            ]
        )
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical.encode()).hexdigest(),
            ]
        )
        date, region, service, _ = scope.split("/")
        key = self.signing_key(secret, date, region, service)
        return hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()

    def _check_v4_header(self, method, path, query, headers, body, auth):
        try:
            # AWS4-HMAC-SHA256 Credential=ak/scope, SignedHeaders=a;b, Signature=x
            fields = dict(
                f.strip().split("=", 1)
                for f in auth[len("AWS4-HMAC-SHA256") :].split(",")
            )
            cred = fields["Credential"]
            signed_headers = fields["SignedHeaders"].split(";")
            given_sig = fields["Signature"]
            access_key, scope = cred.split("/", 1)
        except (KeyError, ValueError):
            return None, ERR_MISSING_FIELDS
        ident = self._by_key.get(access_key)
        if ident is None:
            return None, ERR_INVALID_ACCESS_KEY
        payload_hash = headers.get("X-Amz-Content-Sha256", "")
        if payload_hash == STREAMING_PAYLOAD:
            pass  # seed check only; chunks verified by ChunkedDecoder
        elif payload_hash in ("", UNSIGNED_PAYLOAD):
            payload_hash = payload_hash or UNSIGNED_PAYLOAD
        else:
            if hashlib.sha256(body).hexdigest() != payload_hash:
                return None, ERR_SIGNATURE_MISMATCH
        amz_date = headers.get("X-Amz-Date", "") or headers.get("Date", "")
        sig = self._v4_signature(
            ident.secret_key,
            method,
            path,
            query,
            headers,
            signed_headers,
            payload_hash,
            amz_date,
            scope,
        )
        if not hmac.compare_digest(sig, given_sig):
            return None, ERR_SIGNATURE_MISMATCH
        return ident, ERR_NONE

    def _check_v4_presigned(self, method, path, query, headers):
        try:
            access_key, scope = query["X-Amz-Credential"].split("/", 1)
            signed_headers = query["X-Amz-SignedHeaders"].split(";")
            given_sig = query["X-Amz-Signature"]
            amz_date = query["X-Amz-Date"]
        except KeyError:
            return None, ERR_MISSING_FIELDS
        ident = self._by_key.get(access_key)
        if ident is None:
            return None, ERR_INVALID_ACCESS_KEY
        try:
            signed_at = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=timezone.utc
            )
        except ValueError:
            return None, ERR_MISSING_FIELDS
        try:
            # strict ascii-digit parse: plain int() would accept '+5' and
            # ' 5 ' (values AWS rejects) and still 500 on garbage
            expires = parse_ascii_uint(query.get("X-Amz-Expires", "604800"))
        except ValueError:
            return None, ERR_MALFORMED_QUERY
        if _time.time() > signed_at.timestamp() + expires:
            return None, ERR_EXPIRED_REQUEST
        # a URL "signed" in the future defeats X-Amz-Expires (it would stay
        # valid for future+expires); the reference allows only 15 minutes of
        # clock skew ahead (auth_signature_v4.go:361-364)
        if signed_at.timestamp() > _time.time() + 15 * 60:
            return None, ERR_REQUEST_NOT_READY
        sig = self._v4_signature(
            ident.secret_key,
            method,
            path,
            query,
            headers,
            signed_headers,
            UNSIGNED_PAYLOAD,
            amz_date,
            scope,
            skip_q=("X-Amz-Signature",),
        )
        if not hmac.compare_digest(sig, given_sig):
            return None, ERR_SIGNATURE_MISMATCH
        return ident, ERR_NONE

    def streaming_context(self, headers: dict) -> Optional["StreamingContext"]:
        """Chunk-verification chain for a just-authenticated streaming upload
        (None when auth is disabled or the request wasn't V4-signed)."""
        if not self.enabled:
            return None
        auth = headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256"):
            return None
        try:
            fields = dict(
                f.strip().split("=", 1)
                for f in auth[len("AWS4-HMAC-SHA256") :].split(",")
            )
            access_key, scope = fields["Credential"].split("/", 1)
        except (KeyError, ValueError):
            return None
        ident = self._by_key.get(access_key)
        if ident is None:
            return None
        return StreamingContext(
            ident.secret_key,
            scope,
            headers.get("X-Amz-Date", ""),
            fields["Signature"],
        )

    # -- v2 (legacy) ----------------------------------------------------------
    def _v2_string_to_sign(self, method, path, query, headers) -> str:
        sub_resources = sorted(
            k
            for k in query
            if k
            in (
                "acl", "delete", "lifecycle", "location", "logging",
                "notification", "partNumber", "policy", "requestPayment",
                "tagging", "torrent", "uploadId", "uploads", "versionId",
                "versioning", "versions", "website",
            )
        )
        canon_resource = path
        if sub_resources:
            canon_resource += "?" + "&".join(
                k if not query[k] else f"{k}={query[k]}" for k in sub_resources
            )
        amz = {
            k.lower(): v for k, v in headers.items() if k.lower().startswith("x-amz-")
        }
        amz_lines = "".join(f"{k}:{amz[k]}\n" for k in sorted(amz))
        return "\n".join(
            [
                method,
                headers.get("Content-Md5", ""),
                headers.get("Content-Type", ""),
                headers.get("Date", "") if "x-amz-date" not in amz else "",
            ]
        ) + "\n" + amz_lines + canon_resource

    def _check_v2_header(self, method, path, query, headers, auth):
        try:
            access_key, given = auth[4:].split(":", 1)
        except ValueError:
            return None, ERR_MISSING_FIELDS
        ident = self._by_key.get(access_key)
        if ident is None:
            return None, ERR_INVALID_ACCESS_KEY
        sts = self._v2_string_to_sign(method, path, query, headers)
        sig = base64.b64encode(
            hmac.new(ident.secret_key.encode(), sts.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(sig, given):
            return None, ERR_SIGNATURE_MISMATCH
        return ident, ERR_NONE

    def _check_v2_presigned(self, method, path, query):
        ident = self._by_key.get(query["AWSAccessKeyId"])
        if ident is None:
            return None, ERR_INVALID_ACCESS_KEY
        try:
            # strict: a V2 presign whose Expires is not a plain epoch
            # integer is denied (AWS: 403 "Invalid date format"), not
            # coerced and not a 500
            expires_at = parse_ascii_uint(query.get("Expires", "0"))
        except ValueError:
            return None, ERR_ACCESS_DENIED
        if _time.time() > expires_at:
            return None, ERR_EXPIRED_REQUEST
        sts = "\n".join(
            [method, "", "", query.get("Expires", "")]
        ) + "\n" + path
        sig = base64.b64encode(
            hmac.new(ident.secret_key.encode(), sts.encode(), hashlib.sha1).digest()
        ).decode()
        if not hmac.compare_digest(sig, query["Signature"]):
            return None, ERR_SIGNATURE_MISMATCH
        return ident, ERR_NONE


class ChunkSignatureError(Exception):
    pass


def decode_aws_chunked(
    body: bytes, verify: Optional["StreamingContext"] = None
) -> bytes:
    """Decode the aws-chunked framing of STREAMING-AWS4-HMAC-SHA256-PAYLOAD
    uploads (`chunked_reader_v4.go`): repeated
    `hex-size;chunk-signature=<sig>\\r\\n<data>\\r\\n`, last chunk size 0.
    With a `StreamingContext` each chunk signature is checked against the V4
    chain seeded by the header signature; a mismatch raises
    ChunkSignatureError."""
    out = bytearray()
    pos = 0
    while pos < len(body):
        nl = body.index(b"\r\n", pos)
        header = body[pos:nl].decode()
        size_str, _, sig_part = header.partition(";")
        size = int(size_str, 16)
        if size < 0:
            raise ValueError(f"negative chunk size {size_str!r}")
        pos = nl + 2
        data = body[pos : pos + size]
        if verify is not None:
            given = sig_part.partition("=")[2]
            want = verify.next_chunk_signature(data)
            # compare as bytes: compare_digest raises TypeError on non-ASCII
            # str input, which would turn a garbage signature into a 500
            if not hmac.compare_digest(given.encode(), want.encode()):
                raise ChunkSignatureError(f"chunk at {pos} signature mismatch")
        if size == 0:
            break
        out += data
        pos = pos + size + 2  # trailing \r\n
    return bytes(out)


_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class StreamingContext:
    """Per-request chunk-signature chain for streaming SigV4 uploads.

    chunk_sts = 'AWS4-HMAC-SHA256-PAYLOAD' \\n amz_date \\n scope \\n
                prev_signature \\n sha256('') \\n sha256(chunk_data)
    (AWS SigV4 streaming spec; `chunked_reader_v4.go` buildChunkStringToSign)
    """

    def __init__(self, secret: str, scope: str, amz_date: str, seed_sig: str):
        date, region, service, _ = scope.split("/")
        self.key = IAM.signing_key(secret, date, region, service)
        self.scope = scope
        self.amz_date = amz_date
        self.prev = seed_sig

    def next_chunk_signature(self, data: bytes) -> str:
        sts = "\n".join(
            [
                "AWS4-HMAC-SHA256-PAYLOAD",
                self.amz_date,
                self.scope,
                self.prev,
                _EMPTY_SHA256,
                hashlib.sha256(data).hexdigest(),
            ]
        )
        self.prev = hmac.new(self.key, sts.encode(), hashlib.sha256).hexdigest()
        return self.prev
