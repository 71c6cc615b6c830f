"""Replication sinks: the port's copy of the JAX package's
``replication/sink.py`` (reference iface:
`replication/sink/replication_sink.go:9` — CreateEntry/UpdateEntry/
DeleteEntry against a destination).

The source side reads full object content through the source filer HTTP
(standing in for `source/filer_source.go`, which fetches chunks from volume
servers); sinks write it to their destination.
"""

from __future__ import annotations

import os
from typing import Optional

from ..filer.client import FilerClient
from ..util import faultpoints


class ReplicationSink:
    """One-way destination for filer events."""

    def create_entry(self, key: str, entry: dict, data: Optional[bytes]) -> None:
        raise NotImplementedError

    def update_entry(self, key: str, entry: dict, data: Optional[bytes]) -> None:
        self.create_entry(key, entry, data)

    def delete_entry(self, key: str, is_directory: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Writes to another filer cluster (replication/sink/filersink/).

    `signatures` carries the source cluster's signature into the target's
    meta log so a reverse sync recognizes and skips the event (active-active
    loop prevention, `filer_sync.go:116`)."""

    def __init__(
        self,
        filer_url: str,
        path_prefix: str = "",
        signatures: Optional[list[int]] = None,
    ):
        self.client = FilerClient(filer_url)
        self.prefix = path_prefix.rstrip("/")
        self.signatures = signatures or []
        # extra extended attrs stamped onto every write — the sync loop sets
        # this per-event to `Repl-Ts`/`Repl-Src` so the target records the
        # ORIGIN write's identity (its LWW tiebreak key), not the apply time
        self.stamp: dict[str, str] = {}

    def _path(self, key: str) -> str:
        return self.prefix + key if self.prefix else key

    def create_entry(self, key, entry, data):
        faultpoints.fire("repl.sink.write")
        if entry.get("is_directory"):
            self.client.mkdir(self._path(key), signatures=self.signatures)
            return
        extended = {
            k: v for k, v in entry.get("extended", {}).items() if k != "md5"
        }
        extended.update(self.stamp)
        self.client.put_object(
            self._path(key),
            data or b"",
            content_type=entry.get("mime", ""),
            extended=extended,
            signatures=self.signatures,
        )

    def delete_entry(self, key, is_directory):
        faultpoints.fire("repl.sink.delete")
        self.client.delete(
            self._path(key), recursive=is_directory, signatures=self.signatures
        )


class LocalFsSink(ReplicationSink):
    """Mirrors entries into a local directory tree. Stand-in for the cloud
    bucket sinks (gcssink/azuresink/b2sink) without their SDKs."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.lstrip("/"))

    def create_entry(self, key, entry, data):
        p = self._path(key)
        if entry.get("is_directory"):
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")

    def delete_entry(self, key, is_directory):
        p = self._path(key)
        try:
            if is_directory:
                import shutil

                shutil.rmtree(p, ignore_errors=True)
            else:
                os.unlink(p)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Writes to any S3-compatible endpoint — including our own gateway
    (replication/sink/s3sink/)."""

    def __init__(
        self,
        endpoint: str,
        bucket: str,
        access_key: str = "",
        secret_key: str = "",
        key_prefix: str = "",
    ):
        from ..s3api.s3_client import S3Client

        self.client = S3Client(endpoint, access_key, secret_key)
        self.bucket = bucket
        self.key_prefix = key_prefix.strip("/")

    def _key(self, key: str) -> str:
        k = key.lstrip("/")
        return f"{self.key_prefix}/{k}" if self.key_prefix else k

    def create_entry(self, key, entry, data):
        if entry.get("is_directory"):
            return  # buckets are flat; directories are implicit
        status, body, _ = self.client.put_object(
            self.bucket, self._key(key), data or b""
        )
        if status >= 300:
            # surface the failure — callers retry (repl_util.go); a silent
            # drop here is an invisible hole in the mirror
            raise RuntimeError(
                f"s3 sink PUT {self.bucket}/{self._key(key)}: "
                f"{status} {body[:120]!r}"
            )

    def delete_entry(self, key, is_directory):
        status, body, _ = self.client.delete_object(
            self.bucket, self._key(key)
        )
        if status >= 300 and status != 404:
            raise RuntimeError(
                f"s3 sink DELETE {self.bucket}/{self._key(key)}: "
                f"{status} {body[:120]!r}"
            )
