"""Entry model: FullPath + Attr + chunk list (weed/filer/entry.go:32).

Serialization is JSON (the reference uses protobuf — `entry_codec.go`); the
field names mirror filer_pb so the mapping is 1:1.

The port's copy of the JAX package's ``filer/entry.py``; both packages read and
write the same formats.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FileChunk:
    """One stored chunk of a file (pb/filer.proto FileChunk)."""

    file_id: str  # "3,01637037d6"
    offset: int  # logical offset within the file
    size: int
    mtime: int = 0  # ns; decides overlap winners
    etag: str = ""
    cipher_key: str = ""  # base64 AES-256-GCM key (filer.proto cipher_key)
    is_chunk_manifest: bool = False  # chunk-of-chunks marker (filer.proto)

    def to_dict(self) -> dict:
        d = {
            "file_id": self.file_id,
            "offset": self.offset,
            "size": self.size,
            "mtime": self.mtime,
            "etag": self.etag,
        }
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(
            file_id=d["file_id"],
            offset=d.get("offset", 0),
            size=d.get("size", 0),
            mtime=d.get("mtime", 0),
            etag=d.get("etag", ""),
            cipher_key=d.get("cipher_key", ""),
            is_chunk_manifest=d.get("is_chunk_manifest", False),
        )


@dataclass
class Entry:
    full_path: str  # absolute, "/" separated
    is_directory: bool = False
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mtime: int = field(default_factory=lambda: int(time.time()))
    crtime: int = field(default_factory=lambda: int(time.time()))
    mime: str = ""
    ttl_sec: int = 0
    collection: str = ""
    replication: str = ""
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""
    hard_link_counter: int = 0

    @property
    def name(self) -> str:
        return self.full_path.rstrip("/").rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        p = self.full_path.rstrip("/").rsplit("/", 1)[0]
        return p or "/"

    def file_size(self) -> int:
        return max((c.offset + c.size for c in self.chunks), default=0)

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "is_directory": self.is_directory,
            "mode": self.mode,
            "uid": self.uid,
            "gid": self.gid,
            "mtime": self.mtime,
            "crtime": self.crtime,
            "mime": self.mime,
            "ttl_sec": self.ttl_sec,
            "collection": self.collection,
            "replication": self.replication,
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
            "hard_link_id": self.hard_link_id,
            "hard_link_counter": self.hard_link_counter,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        e = cls(full_path=d["full_path"])
        e.is_directory = d.get("is_directory", False)
        e.mode = d.get("mode", 0o660)
        e.uid = d.get("uid", 0)
        e.gid = d.get("gid", 0)
        e.mtime = d.get("mtime", 0)
        e.crtime = d.get("crtime", 0)
        e.mime = d.get("mime", "")
        e.ttl_sec = d.get("ttl_sec", 0)
        e.collection = d.get("collection", "")
        e.replication = d.get("replication", "")
        e.chunks = [FileChunk.from_dict(c) for c in d.get("chunks", [])]
        e.extended = d.get("extended", {})
        e.hard_link_id = d.get("hard_link_id", "")
        e.hard_link_counter = d.get("hard_link_counter", 0)
        return e
