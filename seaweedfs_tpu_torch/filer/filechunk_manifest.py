"""Chunk manifests: chunk-of-chunks packing for huge files.

Reference: `weed/filer/filechunk_manifest.go` — when a file accumulates
more than ManifestBatch (1000) chunks, each full batch is serialized and
stored as one *manifest chunk* whose `is_chunk_manifest` flag is set and
whose (offset, size) cover the span of its children
(`mergeIntoManifest` :160-188). Reads resolve manifests recursively
(`ResolveChunkManifest` :41) so TB-scale files keep O(size/chunk/1000)
entry metadata. Serialization here is JSON (the entry codec of this
build) instead of the reference's protobuf.

The port's copy of the JAX package's ``filer/filechunk_manifest.py``; both packages read and
write the same formats.
"""

from __future__ import annotations

import json
from typing import Callable

from .entry import FileChunk

MANIFEST_BATCH = 1000

# save(data: bytes) -> FileChunk with file_id/mtime filled in
SaveFunc = Callable[[bytes], FileChunk]
# read(file_id: str, cipher_key: str) -> chunk bytes
ReadFunc = Callable[[str, str], bytes]


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(
    chunks: list[FileChunk],
) -> tuple[list[FileChunk], list[FileChunk]]:
    manifest = [c for c in chunks if c.is_chunk_manifest]
    data = [c for c in chunks if not c.is_chunk_manifest]
    return manifest, data


def serialize_manifest(chunks: list[FileChunk]) -> bytes:
    return json.dumps({"chunks": [c.to_dict() for c in chunks]}).encode()


def parse_manifest(data: bytes) -> list[FileChunk]:
    return [FileChunk.from_dict(d) for d in json.loads(data)["chunks"]]


def maybe_manifestize(
    save: SaveFunc,
    chunks: list[FileChunk],
    batch: int = MANIFEST_BATCH,
) -> list[FileChunk]:
    """Pack every full batch of data chunks into a manifest chunk
    (doMaybeManifestize). Existing manifest chunks pass through; the
    incomplete tail batch stays as plain chunks."""
    out = [c for c in chunks if c.is_chunk_manifest]
    data_chunks = [c for c in chunks if not c.is_chunk_manifest]
    i = 0
    while i + batch <= len(data_chunks):
        group = data_chunks[i : i + batch]
        blob = serialize_manifest(group)
        manifest = save(blob)
        manifest.is_chunk_manifest = True
        manifest.offset = min(c.offset for c in group)
        manifest.size = max(c.offset + c.size for c in group) - manifest.offset
        out.append(manifest)
        i += batch
    out.extend(data_chunks[i:])
    return out


def resolve_chunk_manifest(
    read: ReadFunc, chunks: list[FileChunk]
) -> list[FileChunk]:
    """Expand manifest chunks (recursively) into their data chunks
    (ResolveChunkManifest)."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        children = parse_manifest(read(c.file_id, c.cipher_key))
        out.extend(resolve_chunk_manifest(read, children))
    return out
