"""Transparent gzip compression for stored content.

Mirrors the behavior of the reference's `weed/util/compression.go`
(MaybeGzipData / IsCompressableFileType) and the upload-side decision in
`weed/operation/upload_content.go:107-136`: compress when the file type is
known-compressible; when unsure and no mime is declared, sample the first
128 bytes and keep gzip only if it shrinks below 90%. Content already
bearing the gzip magic is never double-compressed.

The volume data plane stores the compressed bytes with the needle's
FLAG_IS_COMPRESSED set (`weed/storage/needle/needle_parse_upload.go:75`)
and decompresses on read unless the client advertises gzip support.

The port's copy of the upload side of the JAX package's
``util/compression.py`` (the decision and the gzip).
"""

from __future__ import annotations

import gzip as _gzip
import os

GZIP_MAGIC = b"\x1f\x8b"

# known-verdict extension tables (compression.go:118-139)
_COMPRESSIBLE_EXT = {
    ".svg", ".bmp", ".wav",
    ".pdf", ".txt", ".html", ".htm", ".css", ".js", ".json",
    ".php", ".java", ".go", ".rb", ".c", ".cpp", ".h", ".hpp",
    ".py", ".ts", ".md", ".csv", ".xml", ".yaml", ".yml", ".toml",
}
_INCOMPRESSIBLE_EXT = {
    ".zip", ".rar", ".gz", ".bz2", ".xz", ".zst",
    ".png", ".jpg", ".jpeg",
}


def is_gzipped_content(data: bytes) -> bool:
    return len(data) >= 2 and data[:2] == GZIP_MAGIC


def gzip_data(data: bytes) -> bytes:
    # BestSpeed, like the reference — storage compression is about HBM/disk
    # bytes, not archival ratio
    return _gzip.compress(data, compresslevel=1)


def is_compressible_file_type(ext: str, mime: str) -> tuple[bool, bool]:
    """(should_compress, i_am_sure) — IsCompressableFileType
    (compression.go:110). `ext` includes the dot, lowercase."""
    if mime.startswith("text/"):
        return True, True
    if ext in _COMPRESSIBLE_EXT:
        return True, True
    if ext in _INCOMPRESSIBLE_EXT:
        return False, True
    if mime.startswith("image/") or mime.startswith("video/"):
        return False, True
    if mime.startswith("application/"):
        if mime.endswith("zstd") or mime.endswith("zip"):
            return False, True
        if mime.endswith(("xml", "script", "json")):
            return True, True
    if mime.startswith("audio/"):
        if mime.removeprefix("audio/") in ("wave", "wav", "x-wav", "x-pn-wav"):
            return True, True
    return False, False


def _pays_off(original: int, compressed: int) -> bool:
    # keep gzip only below 90% of the original (compression.go:27)
    return compressed * 10 <= original * 9


def maybe_gzip_data(data: bytes) -> bytes:
    """Compress unless it's already gzipped or doesn't pay off."""
    if is_gzipped_content(data):
        return data
    gz = gzip_data(data)
    return gz if _pays_off(len(data), len(gz)) else data


def should_gzip(filename: str, mime: str, data: bytes) -> bool:
    """Upload-side decision (upload_content.go:107-126): type tables first,
    then a 128-byte probe when the type gives no verdict."""
    if is_gzipped_content(data) or len(data) < 128:
        return False
    ext = os.path.splitext(filename)[1].lower()
    should, sure = is_compressible_file_type(ext, mime)
    if sure:
        return should
    if mime == "":
        sample = data[:128]
        return _pays_off(len(sample), len(gzip_data(sample)))
    return False
