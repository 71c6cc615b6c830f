"""Chunk overlap math: chunk list → visible intervals → read views.

Mirrors `weed/filer/filechunks.go:55-225`: chunks are applied in mtime order;
a newer chunk shadows the overlapped ranges of older ones, splitting them
when partially covered. A read range maps to ChunkViews (fid + in-chunk
offset + size) over the visible intervals.

The port's copy of the JAX package's ``filer/filechunks.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .entry import FileChunk

MAX_INT64 = (1 << 63) - 1


@dataclass(frozen=True)
class VisibleInterval:
    start: int
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int  # offset within the stored chunk where this slice begins
    chunk_size: int
    cipher_key: str = ""  # base64 AES-256 key for encrypted chunks


@dataclass(frozen=True)
class ChunkView:
    file_id: str
    offset: int  # offset within the stored chunk
    size: int
    logic_offset: int  # offset within the logical file
    chunk_size: int
    cipher_key: str = ""  # base64 AES-256 key for encrypted chunks

    @property
    def is_full_chunk(self) -> bool:
        return self.size == self.chunk_size


def merge_into_visibles(
    visibles: list[VisibleInterval], chunk: FileChunk
) -> list[VisibleInterval]:
    """Apply one (newer) chunk over the visible set (MergeIntoVisibles)."""
    new_v = VisibleInterval(
        chunk.offset,
        chunk.offset + chunk.size,
        chunk.file_id,
        chunk.mtime,
        0,
        chunk.size,
        chunk.cipher_key,
    )
    if not visibles or visibles[-1].stop <= chunk.offset:
        return visibles + [new_v]
    chunk_stop = chunk.offset + chunk.size
    out: list[VisibleInterval] = []
    for v in visibles:
        if v.start < chunk.offset < v.stop:
            out.append(
                VisibleInterval(
                    v.start,
                    chunk.offset,
                    v.file_id,
                    v.mtime,
                    v.chunk_offset,
                    v.chunk_size,
                    v.cipher_key,
                )
            )
        if v.start < chunk_stop < v.stop:
            out.append(
                VisibleInterval(
                    chunk_stop,
                    v.stop,
                    v.file_id,
                    v.mtime,
                    v.chunk_offset + (chunk_stop - v.start),
                    v.chunk_size,
                    v.cipher_key,
                )
            )
        if chunk_stop <= v.start or v.stop <= chunk.offset:
            out.append(v)
    out.append(new_v)
    out.sort(key=lambda v: v.start)
    return out


def non_overlapping_visible_intervals(
    chunks: list[FileChunk],
) -> list[VisibleInterval]:
    ordered = sorted(chunks, key=lambda c: (c.mtime, c.file_id))
    visibles: list[VisibleInterval] = []
    for chunk in ordered:
        visibles = merge_into_visibles(visibles, chunk)
    return visibles


def view_from_visibles(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    stop = MAX_INT64 if size == MAX_INT64 else offset + size
    if stop < offset:
        stop = MAX_INT64
    views = []
    for v in visibles:
        start = max(offset, v.start)
        end = min(stop, v.stop)
        if start < end:
            views.append(
                ChunkView(
                    file_id=v.file_id,
                    offset=start - v.start + v.chunk_offset,
                    size=end - start,
                    logic_offset=start,
                    chunk_size=v.chunk_size,
                    cipher_key=v.cipher_key,
                )
            )
    return views


def view_from_chunks(
    chunks: list[FileChunk], offset: int, size: int
) -> list[ChunkView]:
    return view_from_visibles(non_overlapping_visible_intervals(chunks), offset, size)


def compact_file_chunks(
    chunks: list[FileChunk],
) -> tuple[list[FileChunk], list[FileChunk]]:
    """(still-referenced, garbage) split (CompactFileChunks)."""
    visible_fids = {v.file_id for v in non_overlapping_visible_intervals(chunks)}
    compacted = [c for c in chunks if c.file_id in visible_fids]
    garbage = [c for c in chunks if c.file_id not in visible_fids]
    return compacted, garbage


def minus_chunks(
    a: list[FileChunk], b: list[FileChunk]
) -> list[FileChunk]:
    """Chunks in a but not b, by fid (DoMinusChunks)."""
    b_fids = {c.file_id for c in b}
    return [c for c in a if c.file_id not in b_fids]


def etag_of_chunks(chunks: list[FileChunk]) -> str:
    """Multi-chunk etag (filer/filechunks.go ETagChunks): md5-of-etags + count."""
    if len(chunks) == 1:
        return chunks[0].etag
    h = hashlib.md5()
    for c in sorted(chunks, key=lambda c: c.offset):
        h.update(c.etag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)
