"""The S3-class cold tier (backend/s3_backend/s3_backend.go), in two layers
as the reference splits it:

``S3BackendStorage``
    One configured backend (s3_backend.go:30): an endpoint and credentials,
    named in ``backend.toml`` or given inline, and the whole-object verbs a
    tier move needs: ``upload_volume`` (a multipart PUT in bounded memory),
    ``download_volume`` (ranged GETs straight to disk), ``verify_object``
    (HEAD and a size check, for a replica that skips the upload another
    replica made).

``RemoteS3File``
    A sealed volume's read handle (s3_backend.go:117): a
    ``BackendStorageFile`` whose ``read_at`` is a ranged GET and whose size
    comes from HEAD. Writes raise: a tiered volume is sealed.

Tests and the GPU check point these at ``fake_s3.FakeS3Server``.
"""

from __future__ import annotations

import os

from ...s3api.s3_client import S3Client
from ...util.parsers import tolerant_uint
from .core import BackendStorageFile


class S3BackendStorage:
    """One S3-compatible backend, named or with inline credentials."""

    def __init__(self, endpoint: str, access_key: str = "", secret_key: str = "",
                 name: str = ""):
        if not endpoint:
            raise ValueError("S3BackendStorage needs an endpoint")
        self.name = name
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.client = S3Client(endpoint, access_key, secret_key)

    # -- whole-object verbs for tier moves -----------------------------------
    def upload_volume(self, bucket: str, key: str, path: str) -> int:
        """Upload a sealed .dat in bounded memory (multipart past one part).
        Idempotent: uploading the same sealed bytes again after a crash
        writes the same object. Returns its size."""
        self.client.create_bucket(bucket)  # an existing bucket is fine
        status = self.client.put_object_from_file(bucket, key, path)
        if status != 200:
            raise IOError(f"tier upload {bucket}/{key}: HTTP {status}")
        return os.path.getsize(path)

    def verify_object(self, bucket: str, key: str, size: int) -> None:
        """HEAD and a size check: a replica that skips the upload still
        proves that the object its descriptor will name exists."""
        status, _, headers = self.client.head_object(bucket, key)
        if status != 200:
            raise IOError(f"tier object {bucket}/{key} missing: HTTP {status}")
        remote_size = tolerant_uint(headers.get("Content-Length", -1), -1)
        if remote_size != size:
            raise IOError(f"tier object {bucket}/{key} size {remote_size} != local {size}")

    def download_volume(self, bucket: str, key: str, path: str) -> int:
        """Ranged-GET the object back to a local path; returns the bytes."""
        return self.client.get_object_to_file(bucket, key, path)


class RemoteS3File(BackendStorageFile):
    """A read-only .dat served by ranged GETs (s3_backend.go:33,117,152:
    ReadAt is a ranged GET, the size comes from HEAD)."""

    def __init__(self, endpoint: str, bucket: str, key: str, access_key: str = "",
                 secret_key: str = "", size: int = -1):
        self.client = S3Client(endpoint, access_key, secret_key)
        self.bucket, self.key = bucket, key
        self._size = size
        if self._size < 0:
            status, _, headers = self.client.head_object(bucket, key)
            if status != 200:
                raise FileNotFoundError(f"s3://{bucket}/{key}: HTTP {status}")
            self._size = tolerant_uint(headers.get("Content-Length", 0), 0)

    def read_at(self, offset: int, size: int) -> bytes:
        if size <= 0 or offset >= self._size:
            return b""
        end = min(offset + size, self._size) - 1
        status, data, _ = self.client.get_object(self.bucket, self.key,
                                                 rng=f"bytes={offset}-{end}")
        if status not in (200, 206):
            raise IOError(f"s3 ranged read {self.key}@{offset}: HTTP {status}")
        return data

    def write_at(self, offset: int, data: bytes) -> int:
        raise IOError("remote-tier volume is read only")

    def append(self, data: bytes) -> int:
        raise IOError("remote-tier volume is read only")

    def truncate(self, size: int) -> None:
        raise IOError("remote-tier volume is read only")

    def size(self) -> int:
        return self._size

    def name(self) -> str:
        return f"s3://{self.bucket}/{self.key}"
