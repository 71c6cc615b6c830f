"""Cloud replication sinks: GCS, Backblaze B2, Azure Blob — the port's copy
of the JAX package's ``replication/cloud_sinks.py``.

Reference: `weed/replication/sink/{gcssink,b2sink,azuresink}`. The Go
implementations wrap vendor SDKs; here GCS and B2 ride their S3-compatible
endpoints through the SigV4 `S3Client` (GCS XML interop with HMAC keys,
B2's S3 API), and Azure speaks its native Blob REST with SharedKey request
signing — all stdlib, no vendor SDK.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timezone

from ..util import glog
from .sink import ReplicationSink, S3Sink

AZURE_API_VERSION = "2019-12-12"


class GcsSink(S3Sink):
    """Google Cloud Storage via the XML/interoperability API
    (`gcssink/gcs_sink.go`). Credentials are HMAC interop keys."""

    def __init__(
        self,
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        key_prefix: str = "",
        endpoint: str = "https://storage.googleapis.com",
    ):
        super().__init__(endpoint, bucket, access_key, secret_key, key_prefix)


class B2Sink(S3Sink):
    """Backblaze B2 via its S3-compatible API (`b2sink/b2_sink.go`)."""

    def __init__(
        self,
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        key_prefix: str = "",
        region: str = "us-west-004",
        endpoint: str = "",
    ):
        super().__init__(
            endpoint or f"https://s3.{region}.backblazeb2.com",
            bucket,
            access_key,
            secret_key,
            key_prefix,
        )


class AzureSink(ReplicationSink):
    """Azure Blob Storage with SharedKey request signing
    (`azuresink/azure_sink.go`; auth per the Storage REST spec).

    `endpoint` defaults to the public blob endpoint for the account;
    overridable for azurite/fakes in tests.
    """

    def __init__(
        self,
        account_name: str,
        account_key: str,
        container: str,
        key_prefix: str = "",
        endpoint: str = "",
    ):
        self.account = account_name
        self.key = base64.b64decode(account_key)
        self.container = container
        self.key_prefix = key_prefix.strip("/")
        self.endpoint = (
            endpoint.rstrip("/")
            or f"https://{account_name}.blob.core.windows.net"
        )

    # -- signing ------------------------------------------------------------
    def _canonicalized_headers(self, headers: dict) -> str:
        ms = sorted(
            (k.lower(), v.strip())
            for k, v in headers.items()
            if k.lower().startswith("x-ms-")
        )
        return "".join(f"{k}:{v}\n" for k, v in ms)

    def _string_to_sign(
        self, verb: str, path: str, headers: dict, content_length: int
    ) -> str:
        # SharedKey (2015-02-21+): empty string for zero Content-Length
        cl = str(content_length) if content_length else ""
        return (
            f"{verb}\n"
            "\n"  # Content-Encoding
            "\n"  # Content-Language
            f"{cl}\n"
            "\n"  # Content-MD5
            f"{headers.get('Content-Type', '')}\n"
            "\n"  # Date (x-ms-date is used instead)
            "\n\n\n\n\n"  # If-* and Range
            f"{self._canonicalized_headers(headers)}"
            f"/{self.account}{path}"
        )

    def _request(self, verb: str, path: str, body: bytes = b"", headers=None):
        headers = dict(headers or {})
        headers["x-ms-date"] = datetime.now(timezone.utc).strftime(
            "%a, %d %b %Y %H:%M:%S GMT"
        )
        headers["x-ms-version"] = AZURE_API_VERSION
        # CanonicalizedResource uses the URI path as sent — percent-encoded
        enc_path = urllib.parse.quote(path)
        sts = self._string_to_sign(verb, enc_path, headers, len(body))
        sig = base64.b64encode(
            hmac.new(self.key, sts.encode(), hashlib.sha256).digest()
        ).decode()
        headers["Authorization"] = f"SharedKey {self.account}:{sig}"
        # PUT always carries a body (b"" still emits Content-Length: 0,
        # which Put Blob requires); bodyless verbs pass None so urllib
        # doesn't inject an unsigned default Content-Type header
        req = urllib.request.Request(
            self.endpoint + enc_path,
            data=body if verb == "PUT" else None,
            method=verb,
            headers=headers,
        )
        try:
            # sweedlint: ok deadline-not-propagated third-party egress; the internal deadline header must not leak to a cloud endpoint
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    # -- sink ops -----------------------------------------------------------
    def _path(self, key: str) -> str:
        k = key.lstrip("/")
        if self.key_prefix:
            k = f"{self.key_prefix}/{k}"
        return f"/{self.container}/{k}"

    def create_entry(self, key, entry, data):
        if entry.get("is_directory"):
            return  # blob namespaces are flat
        status = self._request(
            "PUT",
            self._path(key),
            data or b"",
            {
                "x-ms-blob-type": "BlockBlob",
                "Content-Type": "application/octet-stream",
            },
        )
        if status not in (200, 201):
            # raise so replicator retry loops see it — a logged-and-dropped
            # failure is an invisible hole in the mirror
            raise RuntimeError(f"azure sink: PUT {key} → {status}")

    update_entry = create_entry

    def delete_entry(self, key, is_directory):
        if is_directory:
            return
        status = self._request("DELETE", self._path(key))
        if status not in (200, 202, 404):
            raise RuntimeError(f"azure sink: DELETE {key} → {status}")


def make_sink(conf) -> ReplicationSink:
    """replication.toml → the first enabled sink
    (`replication/sink/replication_sink.go` registry order)."""
    from .sink import FilerSink, LocalFsSink

    if conf.get_bool("sink.local.enabled"):
        return LocalFsSink(conf.get("sink.local.directory", "./replica"))
    if conf.get_bool("sink.filer.enabled"):
        return FilerSink(
            conf.get("sink.filer.grpcAddress", "127.0.0.1:8888"),
            path_prefix=conf.get("sink.filer.directory", ""),
        )
    if conf.get_bool("sink.s3.enabled"):
        return S3Sink(
            conf.get("sink.s3.endpoint", "http://127.0.0.1:8333"),
            conf.get("sink.s3.bucket", "mirror"),
            conf.get("sink.s3.aws_access_key_id", ""),
            conf.get("sink.s3.aws_secret_access_key", ""),
            conf.get("sink.s3.directory", ""),
        )
    if conf.get_bool("sink.gcs.enabled"):
        return GcsSink(
            conf.get("sink.gcs.bucket", ""),
            conf.get("sink.gcs.access_key", ""),
            conf.get("sink.gcs.secret_key", ""),
            conf.get("sink.gcs.directory", ""),
            endpoint=conf.get(
                "sink.gcs.endpoint", "https://storage.googleapis.com"
            ),
        )
    if conf.get_bool("sink.backblaze.enabled"):
        return B2Sink(
            conf.get("sink.backblaze.bucket", ""),
            conf.get("sink.backblaze.b2_account_id", ""),
            conf.get("sink.backblaze.b2_master_application_key", ""),
            conf.get("sink.backblaze.directory", ""),
            region=conf.get("sink.backblaze.region", "us-west-004"),
            endpoint=conf.get("sink.backblaze.endpoint", ""),
        )
    if conf.get_bool("sink.azure.enabled"):
        return AzureSink(
            conf.get("sink.azure.account_name", ""),
            conf.get("sink.azure.account_key", ""),
            conf.get("sink.azure.container", ""),
            conf.get("sink.azure.directory", ""),
            endpoint=conf.get("sink.azure.endpoint", ""),
        )
    raise ValueError("replication.toml: no sink enabled")
