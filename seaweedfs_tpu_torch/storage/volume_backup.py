"""Incremental volume backup by raw .dat tail copy.

Reference: `weed/storage/volume_backup.go` (`IncrementalBackup`) and
`weed/command/backup.go` (`runBackup`). The local copy is a byte-for-byte
prefix of the source volume. Each pass

1. compares the source's compaction revision with the local super block;
   on a mismatch the local copy is wiped and copied again from offset 0
   (the source was compacted, so its offsets moved);
2. appends the source's raw ``.dat`` bytes from the local size to its end,
   in bounded pages (``/admin/incremental_copy``), aborting if the revision
   changes between pages;
3. indexes the newly copied region only: size>0 records are puts, size-0
   records are tombstones (ScanVolumeFileFrom + VolumeFileScanner4GenIdx).

Copying bytes verbatim keeps time stamps, tombstones and empty needles
exactly, and a pass that copies nothing leaves the local copy untouched.
``parse_tail_frames`` decodes the framed needle stream of ``/admin/tail``.
"""

from __future__ import annotations

import os
import struct

from ..server.http_util import http_bytes_headers, http_json
from ..util.parsers import tolerant_uint
from . import idx as idx_mod
from .needle import Needle, get_actual_size, needle_body_length, parse_needle_header
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .types import NEEDLE_HEADER_SIZE, OFFSET_SIZE, needle_map_entry_size
from .volume import Volume, volume_file_name

PAGE_BYTES = 8 * 1024 * 1024


def parse_tail_frames(blob: bytes, version: int) -> list[Needle]:
    """Decode the ``[4-byte length][record]`` frames of /admin/tail."""
    out = []
    pos = 0
    while pos + 4 <= len(blob):
        ln = int.from_bytes(blob[pos:pos + 4], "big")
        pos += 4
        rec = blob[pos:pos + ln]
        pos += ln
        _, _, size = parse_needle_header(rec[:NEEDLE_HEADER_SIZE])
        out.append(Needle.from_bytes(rec, size, version))
    return out


def backup_volume(master_url: str, vid: int, directory: str,
                  collection: str = "") -> dict:
    """One incremental backup pass of volume ``vid`` into ``directory``.
    Returns its counters."""
    r = http_json("GET", f"http://{master_url}/dir/lookup?volumeId={vid}")
    locs = r.get("locations", [])
    if not locs:
        raise RuntimeError(f"volume {vid} not found on any server")
    src = locs[0]["url"]
    st = http_json("GET", f"http://{src}/admin/volume_status?volume={vid}")
    if st.get("error"):
        raise RuntimeError(f"volume status from {src}: {st['error']}")

    base = volume_file_name(directory, collection, vid)
    os.makedirs(directory, exist_ok=True)
    wiped = False
    if os.path.exists(base + ".dat"):
        local = Volume(directory, collection, vid, create_if_missing=False)
        local_rev = local.super_block.compaction_revision
        local.close()
        if local_rev != st["compaction_revision"]:
            # the source was compacted since the last pass: the local bytes
            # are no longer a prefix of its .dat, so start over
            for ext in (".dat", ".idx"):
                if os.path.exists(base + ext):
                    os.unlink(base + ext)
            wiped = True

    start = os.path.getsize(base + ".dat") if os.path.exists(base + ".dat") else 0
    if start == 0 and os.path.exists(base + ".idx"):
        os.unlink(base + ".idx")  # a stale index without its .dat
    if start:
        # resume from the last indexed record, not the raw .dat size: a pass
        # that died after copying but before indexing left bytes without
        # index entries, which are cut and copied again
        indexed_end = _indexed_end(base)
        if indexed_end < start:
            with open(base + ".dat", "r+b") as f:
                f.truncate(indexed_end)
            start = indexed_end
    copied = 0
    start_rev = st["compaction_revision"]
    with open(base + ".dat", "ab") as f:
        offset = start
        while True:
            status, page, hdrs = http_bytes_headers(
                "GET", f"http://{src}/admin/incremental_copy?volume={vid}"
                       f"&offset={offset}&max_bytes={PAGE_BYTES}")
            if status != 200:
                raise RuntimeError(f"incremental copy from {src}: HTTP {status}")
            # a vacuum that commits during the pass rewrites the source
            # .dat: drop what this pass copied and let the next pass's
            # revision check start over
            page_rev = tolerant_uint(hdrs.get("X-Compaction-Revision", start_rev),
                                     start_rev)
            if page_rev != start_rev:
                f.truncate(start)
                f.flush()
                os.fsync(f.fileno())
                raise RuntimeError(
                    f"volume {vid} compacted mid-backup "
                    f"(revision {start_rev} -> {page_rev}); rerun to restart")
            if not page:
                break
            f.write(page)
            offset += len(page)
            copied += len(page)
        f.flush()
        os.fsync(f.fileno())

    # index the new region before opening the Volume: its load cuts any
    # .dat tail past the last indexed record
    writes = deletes = 0
    fresh = start == 0  # the Volume then rebuilds the whole .idx
    if not fresh and copied:
        writes, deletes = _index_region(base, start)
    local = Volume(directory, collection, vid, create_if_missing=False)
    try:
        if fresh:
            writes = local.file_count()
            deletes = local.deleted_count()
        return {
            "volume": vid,
            "from": src,
            "start_offset": start,
            "copied_bytes": copied,
            "writes": writes,
            "deletes": deletes,
            "wiped": wiped,
            "file_count": local.file_count(),
        }
    finally:
        local.close()


def _read_super_block(base: str) -> SuperBlock:
    with open(base + ".dat", "rb") as f:
        head = f.read(SUPER_BLOCK_SIZE)
        extra = struct.unpack(">H", head[6:8])[0]
        return SuperBlock.from_bytes(head + f.read(extra))


def _indexed_end(base: str) -> int:
    """The end of the record of the last .idx entry (a backup's index is
    appended in offset order, so the last entry is the furthest)."""
    sb = _read_super_block(base)
    if not os.path.exists(base + ".idx"):
        return sb.block_size()
    entry_size = needle_map_entry_size(OFFSET_SIZE)
    idx_size = os.path.getsize(base + ".idx")
    idx_size -= idx_size % entry_size
    if idx_size == 0:
        return sb.block_size()
    with open(base + ".idx", "rb") as f:
        f.seek(idx_size - entry_size)
        _, aoff, size = idx_mod.unpack_entry(f.read(entry_size))
    return aoff + get_actual_size(max(size, 0), sb.version)


def _index_region(base: str, start: int) -> tuple[int, int]:
    """Append .idx entries for every record at offset >= ``start`` in the
    .dat. Returns (writes, deletes)."""
    writes = deletes = 0
    sb = _read_super_block(base)
    with open(base + ".dat", "rb") as f, open(base + ".idx", "ab") as out:
        fsize = os.path.getsize(base + ".dat")
        offset = max(start, sb.block_size())
        while offset + NEEDLE_HEADER_SIZE <= fsize:
            f.seek(offset)
            _, nid, nsize = parse_needle_header(f.read(NEEDLE_HEADER_SIZE))
            total = NEEDLE_HEADER_SIZE + needle_body_length(max(nsize, 0), sb.version)
            if offset + total > fsize:
                break
            if nsize > 0:
                out.write(idx_mod.pack_entry(nid, offset, nsize))
                writes += 1
            else:
                out.write(idx_mod.pack_entry(nid, offset, -1))
                deletes += 1
            offset += total
    return writes, deletes
