"""Volume: one append-only .dat + .idx pair holding many needles.

Mirrors `weed/storage/volume.go` + `volume_read_write.go` +
`volume_loading.go` + `volume_checking.go` + `volume_vacuum.go`:

- writes append to .dat and log to .idx (offsets 8-byte aligned, stored /8);
- deletes append a zero-data needle, then log a tombstone .idx entry;
- reads look the needle up in the in-memory map, CRC-verify it and honour
  TTL expiry;
- on load the last ≤10 .idx entries are verified against the .dat and a torn
  tail is truncated (CheckAndFixVolumeDataIntegrity);
- vacuum (``compact``) copies the live needles to .cpd/.cpx while writes go
  on, replays what landed meanwhile under the lock, and swaps the files
  through the staged commit, bumping the super block's compaction revision.

One lock per volume; writes are synchronous and ``sync()`` is explicit.

The needle map kind (``-index``): ``memory``, ``dense``, ``sqlite`` (a
``.ldb`` beside the volume), ``mmap`` (a mapped ``.mdx``) or ``sorted``
(a ``.sdx`` made from the .idx at load; the volume is then read-only).

``attach_turbo`` hands a volume's data plane to the native engine
(``storage/turbo.py``): while attached the engine is the single writer of
the .dat/.idx, lookups and counters go through it, and the Python write and
delete paths append their records through it. ``compact`` detaches for the
rewrite and attaches again over the new files.

The cloud tier (`volume_tier.go`): ``tier_upload`` seals a volume and moves
its .dat to an S3-class backend, keeping the .idx local; a ``.tier``
descriptor names the object, and reads go on as ranged GETs. A volume whose
.dat lives remotely loads from that descriptor. ``tier_download`` brings the
.dat back through the staged commit. The engine never owns a tiered volume.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import time
from typing import Iterator, Optional

from ..stats.heat import EwmaHeat
from ..util import faultpoints
from ..util.locks import make_rlock
from ..util.throttler import WriteThrottler
from . import idx as idx_mod
from .backend import BackendStorageFile, DiskFile, RemoteS3File, S3BackendStorage
from .backend_config import resolve_backend
from .commit import StagedCommit, atomic_write
from .needle import (
    CURRENT_VERSION,
    FLAG_HAS_LAST_MODIFIED,
    FLAG_HAS_TTL,
    Needle,
    get_actual_size,
    needle_body_length,
    parse_needle_header,
)
from .needle_map import CompactNeedleMap
from .needle_map_dense import (
    DenseNeedleMap,
    MmapNeedleMap,
    SortedFileNeedleMap,
    SqliteNeedleMap,
    write_sorted_index,
)
from .replica_placement import ReplicaPlacement
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .ttl import EMPTY_TTL, TTL
from .types import (
    NEEDLE_HEADER_SIZE,
    OFFSET_SIZE,
    max_possible_volume_size,
    needle_map_entry_size,
    size_is_valid,
)

# the needle map kinds `-index` offers
NEEDLE_MAP_KINDS = ("memory", "dense", "sqlite", "sorted", "mmap")


class NotFoundError(Exception):
    pass


class DeletedError(Exception):
    pass


class VolumeError(Exception):
    pass


def volume_file_name(directory: str, collection: str, vid: int) -> str:
    """`<dir>/<collection>_<vid>` or `<dir>/<vid>` (volume.go FileName)."""
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))


def check_needle_map_kind(kind: str) -> None:
    if kind not in NEEDLE_MAP_KINDS:
        raise ValueError(f"unknown needle map kind {kind!r} "
                         f"(want one of {', '.join(NEEDLE_MAP_KINDS)})")


class Volume:
    def __init__(
        self,
        directory: str,
        collection: str,
        vid: int,
        replica_placement: Optional[ReplicaPlacement] = None,
        ttl: TTL = EMPTY_TTL,
        version: int = CURRENT_VERSION,
        offset_size: int = OFFSET_SIZE,
        create_if_missing: bool = True,
        needle_map_kind: str = "dense",
    ):
        check_needle_map_kind(needle_map_kind)
        self.dir = directory
        self.collection = collection
        self.id = vid
        self.offset_size = offset_size
        self.needle_map_kind = needle_map_kind
        # the native engine (storage/turbo.py) while it owns the data plane
        self.turbo = None
        self._turbo_writable_http = True
        self.read_only = False
        self.last_append_at_ns = 0
        self._lock = make_rlock("Volume._lock")
        self._is_compacting = False
        # zipfian-skew signal: decayed op counters marked by the store,
        # shipped in heartbeats
        self.read_heat = EwmaHeat()
        self.write_heat = EwmaHeat()

        base = self.file_name()
        tier_exists = os.path.exists(base + ".tier")
        dat_exists = os.path.exists(base + ".dat") or tier_exists
        if not dat_exists and not create_if_missing:
            raise FileNotFoundError(base + ".dat")
        if tier_exists:
            # a sealed volume whose .dat lives on a remote tier
            with open(base + ".tier") as f:
                info = json.load(f)
            endpoint, ak, sk = Volume._tier_credentials(info)
            self.data_backend: BackendStorageFile = RemoteS3File(
                endpoint, info["bucket"], info["key"], ak, sk, size=info["size"])
            self.read_only = True
        else:
            self.data_backend = DiskFile(base + ".dat", create=True)
        if dat_exists and self.data_backend.size() >= SUPER_BLOCK_SIZE:
            head = self.data_backend.read_at(0, SUPER_BLOCK_SIZE)
            extra_size = struct.unpack(">H", head[6:8])[0]
            self.super_block = SuperBlock.from_bytes(
                self.data_backend.read_at(0, SUPER_BLOCK_SIZE + extra_size))
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl,
            )
            self.data_backend.write_at(0, self.super_block.to_bytes())

        idx_path = base + ".idx"
        if not os.path.exists(idx_path) and dat_exists:
            self._rebuild_index(idx_path)
        # unbuffered: .idx appends are visible at once to other readers of
        # the file (EC encode reads the .idx of a live volume); one 16-byte
        # write(2) per put, as the reference's os.File.Write
        idx_file = open(idx_path, "a+b", buffering=0)
        try:
            # the needle map owns the file from here (nm.close() closes it)
            self.nm = self._load_needle_map(idx_file)
            self.last_append_at_ns = self._check_and_fix_integrity(idx_file)
        except Exception:
            idx_file.close()
            self.data_backend.close()
            raise

    def _load_needle_map(self, idx_file):
        kind, base = self.needle_map_kind, self.file_name()
        if kind == "memory":
            return CompactNeedleMap.load(idx_file, self.offset_size)
        if kind == "dense":
            return DenseNeedleMap.load(idx_file, self.offset_size)
        if kind == "sqlite":
            return SqliteNeedleMap.load(idx_file, base + ".ldb", self.offset_size)
        if kind == "mmap":
            return MmapNeedleMap.load(idx_file, base + ".mdx", self.offset_size)
        # sorted (needle_map_sorted_file.go): make or refresh the .sdx from
        # the .idx, then binary-search it on disk; the volume is sealed
        sdx, idxp = base + ".sdx", base + ".idx"
        if not os.path.exists(sdx) or os.path.getmtime(sdx) < os.path.getmtime(idxp):
            with open(idxp, "rb") as f:
                write_sorted_index(f.read(), sdx, self.offset_size)
        # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
        self.read_only = True
        return SortedFileNeedleMap(sdx, self.offset_size, idx_file)

    # -- native turbo attach/detach ------------------------------------------
    @property
    def read_only(self) -> bool:
        return self._read_only

    @read_only.setter
    def read_only(self, value: bool) -> None:
        self._read_only = value
        # sweedlint: ok lock-discipline GIL-atomic reference read; attach/detach swap it under the lock
        engine = self.turbo
        if engine is not None:  # the engine refuses its own writes too
            engine.set_readonly(self.id, value)

    def attach_turbo(self, engine, writable_http: bool = True) -> bool:
        """Hand the data plane to the native engine. Refused for volumes the
        engine cannot own (a sorted or mmap needle map, a non-disk backend,
        a volume-level TTL the native writer would not inherit)."""
        # sweedlint: ok lock-discipline admin pre-check; attach is store-serialized, worst case re-attach returns True
        if self.turbo is not None:
            return True
        if self.needle_map_kind in ("sorted", "mmap"):
            # sorted is sealed; mmap's base is an immutable mapping the
            # engine cannot own as its writable .idx-backed map
            return False
        # sweedlint: ok lock-discipline admin pre-check; tier moves exclude attach via the store
        if not isinstance(self.data_backend, DiskFile):
            return False
        if self.ttl != EMPTY_TTL:
            return False
        from .turbo import TurboNeedleMap

        base = self.file_name()
        with self._lock:
            # sweedlint: ok blocking-under-lock flush-before-handoff; the native engine must see a complete .dat
            self.sync()  # the engine must see a complete .dat
            if not engine.register(self.id, base + ".dat", base + ".idx", self.version,
                                   self.offset_size, writable_http, self._read_only):
                return False
            idx_file = self.nm._index_file
            self.nm.release()
            self.nm = TurboNeedleMap(engine, self.id, idx_file, self.offset_size)
            self.turbo = engine
            self._turbo_writable_http = writable_http
        return True

    def detach_turbo(self, reload_map: bool = True) -> None:
        """Take the data plane back: reload the Python needle map from the
        .idx the engine kept current."""
        # sweedlint: ok lock-discipline admin pre-check; the locked block re-reads the reference
        if self.turbo is None:
            return
        with self._lock:
            engine = self.turbo
            self.turbo = None
            engine.unregister(self.id)
            idx_file = self.nm._index_file
            if reload_map:
                self.nm = self._load_needle_map(idx_file)
            else:
                self.nm = CompactNeedleMap(idx_file, self.offset_size)

    @contextlib.contextmanager
    def _turbo_reattach_ctx(self):
        """Detach for a file-rewriting operation, attach again after."""
        # sweedlint: ok lock-discipline admin pre-check; detach/attach re-read the reference under the lock
        engine = self.turbo
        # sweedlint: ok lock-discipline admin pre-check; detach/attach re-read the reference under the lock
        writable = self._turbo_writable_http
        self.detach_turbo()
        try:
            yield
        finally:
            if engine is not None:
                self.attach_turbo(engine, writable)

    # -- identity and counters -----------------------------------------------
    def file_name(self) -> str:
        return volume_file_name(self.dir, self.collection, self.id)

    @property
    def version(self) -> int:
        # sweedlint: ok lock-discipline GIL-atomic reference read; only the locked compact commit replaces super_block
        return self.super_block.version

    @property
    def ttl(self) -> TTL:
        # sweedlint: ok lock-discipline GIL-atomic reference read; only the locked compact commit replaces super_block
        return self.super_block.ttl

    def content_size(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; nm reference swaps are GIL-atomic
        return self.nm.content_size()

    def deleted_size(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; nm reference swaps are GIL-atomic
        return self.nm.deleted_size()

    def file_count(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; nm reference swaps are GIL-atomic
        return self.nm.file_count()

    def deleted_count(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; nm reference swaps are GIL-atomic
        return self.nm.deleted_count()

    def max_file_key(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; nm reference swaps are GIL-atomic
        return self.nm.max_file_key

    def size(self) -> int:
        # sweedlint: ok lock-discipline heartbeat stat read; backend reference swaps are GIL-atomic
        return self.data_backend.size()

    def is_tiered(self) -> bool:
        """True while the .dat lives on a remote backend; by type, not by a
        stat of the .tier file, since every heartbeat asks."""
        # sweedlint: ok lock-discipline heartbeat stat read; backend reference swaps are GIL-atomic
        return isinstance(self.data_backend, RemoteS3File)

    def garbage_level(self) -> float:
        """Vacuum's trigger: deleted bytes over all content bytes ever
        written (volume.go garbageLevel; ContentSize counts every put)."""
        if self.content_size() == 0:
            return 0.0
        return self.deleted_size() / self.content_size()

    # -- load-time integrity (volume_checking.go:16-44) ----------------------
    def _check_and_fix_integrity(self, idx_file) -> int:
        entry_size = 8 + self.offset_size + 4
        idx_size = os.path.getsize(idx_file.name)
        if idx_size % entry_size:
            idx_size -= idx_size % entry_size
            idx_file.truncate(idx_size)
        if idx_size == 0:
            return 0
        healthy = idx_size
        last_append_at_ns = 0
        last_good: Optional[tuple[int, int]] = None
        with open(idx_file.name, "rb") as f:
            for i in range(1, 11):
                off = idx_size - i * entry_size
                if off < 0:
                    break
                f.seek(off)
                key, aoff, size = idx_mod.unpack_entry(f.read(entry_size), self.offset_size)
                ok, ns = self._verify_entry(key, aoff, size)
                if ok:
                    last_append_at_ns = ns
                    last_good = (aoff, size)
                    break
                healthy = off
        if healthy < idx_size:
            # reload the map (entries and counters) without the torn tail
            idx_file.truncate(healthy)
            # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
            self.nm.release()
            # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
            self.nm = self._load_needle_map(idx_file)
        # cut any .dat tail past the last record, so the next append starts
        # at an aligned offset (the reference leaves it and its ToOffset
        # rounds the next offset down)
        if last_good is not None:
            aoff, size = last_good
            record_end = aoff + get_actual_size(max(size, 0), self.version)
            # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
            if self.data_backend.size() > record_end:
                # the last entry need not be the last record: a decoded
                # volume's .idx is in key order. Only bytes past every
                # record the index knows are a torn tail.
                record_end = max(record_end, self._furthest_record_end(idx_file.name))
                # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
                if self.data_backend.size() > record_end:
                    # sweedlint: ok lock-discipline load path; runs in __init__ before the volume is shared
                    self.data_backend.truncate(record_end)
        return last_append_at_ns

    def _furthest_record_end(self, idx_path: str) -> int:
        end = 0
        with open(idx_path, "rb") as f:
            for _, aoff, size in idx_mod.iter_index_file(f, self.offset_size):
                if aoff:
                    end = max(end, aoff + get_actual_size(max(size, 0), self.version))
        return end

    def _verify_entry(self, key: int, aoff: int, size: int) -> tuple[bool, int]:
        if aoff == 0 and size == 0:
            return True, 0
        # a tombstone entry points at the appended deletion needle
        # (verifyDeletedNeedleIntegrity): it must exist and match
        want = 0 if size < 0 else size
        blob_len = get_actual_size(want, self.version)
        # sweedlint: ok lock-discipline called from the __init__ load path only
        blob = self.data_backend.read_at(aoff, blob_len)
        if len(blob) < blob_len:
            return False, 0
        try:
            _, nid, nsize = parse_needle_header(blob[:NEEDLE_HEADER_SIZE])
            if nid != key or nsize != want:
                return False, 0
            n = Needle.from_bytes(blob, want, self.version)
        except Exception:  # noqa: BLE001 — any parse failure is a torn record
            return False, 0
        return True, n.append_at_ns

    def _rebuild_index(self, idx_path: str) -> None:
        """Scan the .dat and regenerate the .idx (super block → needles)."""
        with open(idx_path, "wb") as out:
            for n, offset, _ in self.scan_needles():
                size = n.size if (n.size > 0 or n.data) else -1
                out.write(idx_mod.pack_entry(n.id, offset, size, self.offset_size))

    # -- write path (volume_read_write.go:78-128) ----------------------------
    def write_needle(self, n: Needle, fsync: bool = False,
                     append_at_ns: Optional[int] = None) -> tuple[int, int, bool]:
        """Returns (offset, size, is_unchanged)."""
        if n.ttl == EMPTY_TTL and self.ttl != EMPTY_TTL:
            n.set_flag(FLAG_HAS_TTL)
            n.ttl = self.ttl
        with self._lock:
            # under the lock: a write must not race past a concurrent seal
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read only")
            actual_size = get_actual_size(len(n.data), self.version)
            if max_possible_volume_size(self.offset_size) < self.nm.content_size() + actual_size:
                raise VolumeError(f"volume {self.id} size limit exceeded "
                                  f"(content {self.nm.content_size()})")
            if self._is_file_unchanged(n):
                return 0, len(n.data), True
            nv = self.nm.get(n.id)
            if nv is not None and nv.offset != 0:
                hdr = self.data_backend.read_at(nv.offset, NEEDLE_HEADER_SIZE)
                try:
                    cookie, _, _ = parse_needle_header(hdr)
                except Exception as e:  # noqa: BLE001 — a short header
                    raise VolumeError(f"reading existing needle: {e}") from e
                if cookie != n.cookie:
                    raise VolumeError(f"mismatching cookie {n.cookie:x}")
            n.append_at_ns = append_at_ns or time.time_ns()
            blob = n.to_bytes(self.version)
            if self.turbo is not None:
                if n.id == 0xFFFFFFFFFFFFFFFF:
                    # the native map's empty-slot sentinel: a record under it
                    # would vanish at the next table growth
                    raise VolumeError("key ffffffffffffffff is reserved on "
                                      "native-attached volumes")
                # the engine appends the record, logs the .idx entry and
                # updates its map under its own per-volume lock
                offset = self.turbo.append(self.id, n.id, blob, n.size, False)
            else:
                offset = self.data_backend.append(blob)
                if nv is None or nv.offset < offset:
                    self.nm.put(n.id, offset, n.size)
            self.last_append_at_ns = n.append_at_ns
            if fsync:
                # sweedlint: ok blocking-under-lock write→fsync→ack ordering under the lock IS the durability contract (docs/CRASH.md)
                self.sync()
            return offset, n.size, False

    def _is_file_unchanged(self, n: Needle) -> bool:
        if str(self.ttl):
            return False
        # sweedlint: ok lock-discipline called with self._lock held by write_needle
        nv = self.nm.get(n.id)
        if nv is None or nv.offset == 0 or not size_is_valid(nv.size):
            return False
        try:
            # sweedlint: ok lock-discipline called with self._lock held by write_needle
            blob = self.data_backend.read_at(nv.offset, get_actual_size(nv.size, self.version))
            old = Needle.from_bytes(blob, nv.size, self.version)
        except Exception:  # noqa: BLE001 — unreadable old copy: not unchanged
            return False
        return old.cookie == n.cookie and old.data == n.data

    # -- delete path (volume_read_write.go:194-220) --------------------------
    def delete_needle(self, n: Needle, append_at_ns: Optional[int] = None) -> int:
        """Returns the size of the deleted needle (0 if absent)."""
        with self._lock:
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read only")
            nv = self.nm.get(n.id)
            if nv is None or not size_is_valid(nv.size):
                return 0
            n.data = b""
            n.append_at_ns = append_at_ns or time.time_ns()
            blob = n.to_bytes(self.version)
            if self.turbo is not None:
                self.turbo.append(self.id, n.id, blob, 0, True)
            else:
                self.nm.delete(n.id, self.data_backend.append(blob))
            self.last_append_at_ns = n.append_at_ns
            return nv.size

    # -- read path (volume_read_write.go:262-302) ----------------------------
    def read_needle(self, n: Needle, read_deleted: bool = False) -> int:
        with self._lock:
            nv = self.nm.get(n.id)
            if nv is None or nv.offset == 0:
                raise NotFoundError(f"needle {n.id:x} not found")
            read_size = nv.size
            if read_size < 0:  # deleted (size 0 is a valid empty needle)
                if read_deleted and read_size != -1:
                    read_size = -read_size
                else:
                    raise DeletedError(f"needle {n.id:x} deleted")
            if read_size == 0:
                return 0
            blob = self.data_backend.read_at(nv.offset, get_actual_size(read_size, self.version))
        m = Needle.from_bytes(blob, read_size, self.version)
        n.__dict__.update(m.__dict__)
        if (not n.has(FLAG_HAS_TTL) or n.ttl.minutes() == 0
                or not n.has(FLAG_HAS_LAST_MODIFIED)):
            return len(n.data)
        if time.time() < n.last_modified + n.ttl.minutes() * 60:
            return len(n.data)
        raise NotFoundError(f"needle {n.id:x} expired")

    def read_needle_extent(self, n: Needle, min_size: int = 0) -> Optional[tuple]:
        """Zero-copy read setup: parse everything but the data region.

        Returns ``(file, data_offset, data_len)``, where ``file`` is a dup
        of the .dat fd that the caller sendfiles from ``data_offset`` and
        must close; or None when the record does not qualify (a v1 layout,
        an empty needle, below ``min_size``, any parse irregularity), and
        the caller takes the buffered ``read_needle`` path, which also gives
        the proper error for a corrupt record. Not found, deleted and
        expired raise as ``read_needle`` does. ``n``'s metadata (cookie,
        flags, name, mime, ttl, ...) is filled in and ``n.data`` stays
        empty. The data CRC is not verified on this path: the bytes go from
        the page cache to the socket (the scrub is its safety net)."""
        with self._lock:
            if self.version == 1:
                return None
            backend_fileno = getattr(self.data_backend, "fileno", None)
            if backend_fileno is None:
                return None
            nv = self.nm.get(n.id)
            if nv is None or nv.offset == 0:
                raise NotFoundError(f"needle {n.id:x} not found")
            read_size = nv.size
            if read_size < 0:
                raise DeletedError(f"needle {n.id:x} deleted")
            if read_size == 0:
                return None
            head = self.data_backend.read_at(nv.offset, NEEDLE_HEADER_SIZE + 4)
            if len(head) < NEEDLE_HEADER_SIZE + 4:
                return None
            m = Needle()
            m.parse_header(head[:NEEDLE_HEADER_SIZE])
            if m.size != read_size:
                return None  # the buffered path raises the proper mismatch
            data_len = struct.unpack(">I", head[NEEDLE_HEADER_SIZE:])[0]
            if data_len < max(1, min_size):
                return None
            # the tail: flags byte + optional name/mime/last_modified/ttl/pairs
            tail_len = read_size - 4 - data_len
            if tail_len < 1:
                return None
            tail = self.data_backend.read_at(nv.offset + NEEDLE_HEADER_SIZE + 4 + data_len,
                                             tail_len)
            if len(tail) < tail_len:
                return None
            # dup under the lock: a compaction's commit swaps data_backend,
            # and the offset and the fd must come from the same generation
            fd = os.dup(backend_fileno())
        try:
            # the buffered path's own tail parser, over an empty data region
            m._read_body_v2(struct.pack(">I", 0) + tail)
        except Exception:  # noqa: BLE001 — irregular tail: the buffered path decides
            os.close(fd)
            return None
        m.size = read_size
        n.__dict__.update(m.__dict__)
        n.data = b""
        if (n.has(FLAG_HAS_TTL) and n.ttl.minutes() != 0 and n.has(FLAG_HAS_LAST_MODIFIED)
                and time.time() >= n.last_modified + n.ttl.minutes() * 60):
            os.close(fd)
            raise NotFoundError(f"needle {n.id:x} expired")
        return os.fdopen(fd, "rb", buffering=0), nv.offset + NEEDLE_HEADER_SIZE + 4, data_len

    # -- sequential scan -----------------------------------------------------
    def scan_needles(self, verify_crc: bool = False) -> Iterator[tuple[Needle, int, int]]:
        """Yield (needle, offset, total_len) for every record in the .dat, up
        to its size when the scan starts (the .dat only grows)."""
        # sweedlint: ok lock-discipline point-in-time scan; .dat is append-only below the snapshot size
        size = self.data_backend.size()
        # sweedlint: ok lock-discipline GIL-atomic reference read; only the locked compact commit replaces super_block
        offset = self.super_block.block_size()
        version = self.version
        while offset + NEEDLE_HEADER_SIZE <= size:
            # sweedlint: ok lock-discipline point-in-time scan; .dat is append-only below the snapshot size
            hdr = self.data_backend.read_at(offset, NEEDLE_HEADER_SIZE)
            cookie, nid, nsize = parse_needle_header(hdr)
            body_len = needle_body_length(max(nsize, 0), version)
            total = NEEDLE_HEADER_SIZE + body_len
            if offset + total > size:
                break
            n = Needle(cookie=cookie, id=nid, size=nsize)
            # sweedlint: ok lock-discipline point-in-time scan; .dat is append-only below the snapshot size
            body = self.data_backend.read_at(offset + NEEDLE_HEADER_SIZE, body_len)
            try:
                n.read_body_bytes(body, version)
            except Exception:  # noqa: BLE001 — a corrupt body
                if verify_crc:
                    raise
            yield n, offset, total
            offset += total

    # -- tail / backup (storage/volume_backup.go) ----------------------------
    def tail_needles(self, since_ns: int) -> Iterator[Needle]:
        """Records appended after ``since_ns``, in append order: the
        incremental follow stream (VolumeTailSender). Tombstones come as
        size-0 records."""
        for n, _, _ in self.scan_needles():
            if n.append_at_ns > since_ns:
                yield n

    # -- vacuum / compaction (volume_vacuum.go) ------------------------------
    def compact(self, bytes_per_second: int = 0) -> None:
        """Concurrent compaction (the reference's ``Compact2`` +
        ``makeupDiff``, `volume_vacuum.go:66,181`). Phases 1 and 2 run
        without the lock while writes and deletes go on: the live map comes
        from the .idx prefix of the snapshot, and the live needles below the
        snapshot's .dat size are copied to .cpd/.cpx. Phase 3 takes the lock,
        replays every .idx entry appended since the snapshot (a put copies
        the new needle, a delete copies its tombstone needle) and swaps the
        files through the staged commit. Both logs are append-only, so the
        bytes below the snapshot sizes do not change under the copy.

        ``bytes_per_second`` paces the unlocked copy (compactionBytePerSecond);
        0 is unthrottled. A volume the native engine owns is detached for the
        compaction and attached again over the compacted files."""
        # sweedlint: ok lock-discipline admin pre-check; the reattach ctx re-reads under the lock
        if self.turbo is not None:
            with self._turbo_reattach_ctx():
                return self._compact(bytes_per_second)
        return self._compact(bytes_per_second)

    def _compact(self, bytes_per_second: int) -> None:
        throttler = WriteThrottler(bytes_per_second)
        with self._lock:
            if self._is_compacting:
                raise VolumeError(f"volume {self.id} is already compacting")
            self._is_compacting = True
        base = self.file_name()
        entry_size = needle_map_entry_size(self.offset_size)
        version = self.version
        try:
            with self._lock:
                # sweedlint: ok blocking-under-lock snapshot point: the sizes below are only meaningful after a flush
                self.sync()  # the snapshot sizes hold only after a flush
                snap_dat = self.data_backend.size()
                snap_idx = self.nm.index_file_size()
                sb = self.super_block
            new_sb = SuperBlock(
                version=version,
                replica_placement=sb.replica_placement,
                ttl=sb.ttl,
                compaction_revision=(sb.compaction_revision + 1) & 0xFFFF,
                extra=sb.extra,
            )
            # phase 1 (no lock): the live map as of the snapshot
            live: dict[int, tuple[int, int]] = {}
            with open(base + ".idx", "rb") as f:
                prefix = f.read(snap_idx)
            for i in range(0, len(prefix) - entry_size + 1, entry_size):
                key, off, size = idx_mod.unpack_entry(
                    prefix[i:i + entry_size], self.offset_size)
                if size_is_valid(size):
                    live[key] = (off, size)
                else:
                    live.pop(key, None)
            # phase 2 (no lock): live needles in .dat order up to the snapshot
            with open(base + ".cpd", "wb") as dst, open(base + ".cpx", "wb") as dst_idx:
                dst.write(new_sb.to_bytes())
                new_offset = new_sb.block_size()
                offset = sb.block_size()
                while offset + NEEDLE_HEADER_SIZE <= snap_dat:
                    # sweedlint: ok lock-discipline deliberate lock-free copy phase; bytes below snap_dat are immutable
                    hdr = self.data_backend.read_at(offset, NEEDLE_HEADER_SIZE)
                    if len(hdr) < NEEDLE_HEADER_SIZE:
                        break
                    _, nid, nsize = parse_needle_header(hdr)
                    total = NEEDLE_HEADER_SIZE + needle_body_length(max(nsize, 0), version)
                    if offset + total > snap_dat:
                        break
                    lv = live.get(nid)
                    if lv is not None and lv[0] == offset and size_is_valid(lv[1]):
                        faultpoints.fire("vacuum.copy", path=base + ".cpd")
                        # sweedlint: ok lock-discipline deliberate lock-free copy phase; bytes below snap_dat are immutable
                        dst.write(self.data_backend.read_at(offset, total))
                        dst_idx.write(idx_mod.pack_entry(nid, new_offset, nsize,
                                                         self.offset_size))
                        new_offset += total
                        throttler.maybe_slowdown(total)
                    offset += total
                # phase 3 (locked): makeupDiff, then the swap
                with self._lock:
                    # sweedlint: ok blocking-under-lock makeupDiff snapshot: the .idx tail must be flushed before replay; writers are excluded on purpose
                    self.sync()
                    end_idx = self.nm.index_file_size()
                    if end_idx > snap_idx:
                        with open(base + ".idx", "rb") as f:
                            f.seek(snap_idx)
                            diff = f.read(end_idx - snap_idx)
                        for i in range(0, len(diff) - entry_size + 1, entry_size):
                            key, off, size = idx_mod.unpack_entry(
                                diff[i:i + entry_size], self.offset_size)
                            # a delete copies its tombstone needle and points
                            # the entry at it: a tombstone at offset 0 would
                            # fail the load-time check, be truncated away and
                            # bring the needle back
                            body = size if size_is_valid(size) else 0
                            total = NEEDLE_HEADER_SIZE + needle_body_length(body, version)
                            dst.write(self.data_backend.read_at(off, total))
                            dst_idx.write(idx_mod.pack_entry(key, new_offset, size,
                                                             self.offset_size))
                            new_offset += total
                    dst.close()
                    dst_idx.close()
                    # sweedlint: ok blocking-under-lock compact commit swaps .dat/.idx and must exclude writers (docs/CRASH.md); faultpoint sleeps are test-only
                    self._commit_compact(base)
        finally:
            with self._lock:
                self._is_compacting = False

    # the reference's Compact2 is this compaction
    compact2 = compact

    def _commit_compact(self, base: str) -> None:
        """Swap the compacted pair in as one staged commit, so that a crash
        never leaves the new .dat live against the old .idx."""
        with self._lock:
            self._commit_compact_locked(base)

    def _commit_compact_locked(self, base: str) -> None:
        self.data_backend.close()
        self.nm.close()
        sc = StagedCommit(base, "vacuum")
        sc.stage(base + ".dat", tmp_path=base + ".cpd")
        sc.stage(base + ".idx", tmp_path=base + ".cpx")
        # sweedlint: ok blocking-under-lock compact commit swaps .dat/.idx; it must exclude writers (docs/CRASH.md)
        sc.commit()
        self.data_backend = DiskFile(base + ".dat")
        head = self.data_backend.read_at(0, SUPER_BLOCK_SIZE)
        extra_size = struct.unpack(">H", head[6:8])[0]
        self.super_block = SuperBlock.from_bytes(
            self.data_backend.read_at(0, SUPER_BLOCK_SIZE + extra_size))
        # a fresh map from the new .idx: nothing keeps the old offsets
        idx_file = open(base + ".idx", "a+b", buffering=0)
        try:
            self.nm = self._load_needle_map(idx_file)
        except Exception:
            idx_file.close()
            raise

    # -- cloud tier (storage/volume_tier.go) ---------------------------------
    def tier_file(self) -> str:
        return self.file_name() + ".tier"

    @staticmethod
    def _tier_credentials(info: dict) -> tuple[str, str, str]:
        """A .tier descriptor -> (endpoint, access_key, secret_key): a named
        backend resolves through backend.toml, an inline one carries them."""
        if info.get("backend"):
            bc = resolve_backend(info["backend"])
            return bc["endpoint"], bc["access_key"], bc["secret_key"]
        return info.get("endpoint", ""), info.get("access_key", ""), info.get("secret_key", "")

    def tier_upload(self, endpoint: str = "", bucket: str = "", access_key: str = "",
                    secret_key: str = "", keep_local: bool = False, skip_upload: bool = False,
                    backend: str = "") -> dict:
        """Seal the volume and move its .dat to an S3-compatible backend,
        keeping the .idx local; reads go on through ranged GETs
        (volume_tier.go, volume_grpc_tier_upload.go). With ``skip_upload`` a
        replica verifies the object another replica uploaded and writes only
        its own descriptor. Returns the descriptor without credentials."""
        if backend:
            # the named backend wins: the descriptor stores only its name, so
            # the upload must go where a later reopen will look
            bc = resolve_backend(backend)
            endpoint, access_key, secret_key = bc["endpoint"], bc["access_key"], bc["secret_key"]
        if not endpoint:
            raise VolumeError("tier_upload needs -backend or an endpoint")
        self.detach_turbo()  # the .dat is about to leave the local disk
        with self._lock:
            was_read_only = self.read_only
            self.read_only = True
            try:
                # the sealed snapshot includes every acknowledged write
                # sweedlint: ok blocking-under-lock seal point: the upload snapshot must include every acked write
                self.data_backend.sync()
                key = f"{self.collection or 'default'}_{self.id}.dat"
                size = self.data_backend.size()
                local = self.file_name() + ".dat"
                s3 = S3BackendStorage(endpoint, access_key, secret_key, name=backend)
                if skip_upload:
                    # sweedlint: ok blocking-under-lock admin-plane tier move on a sealed volume; the held lock is the exclusivity the backend swap needs
                    s3.verify_object(bucket, key, size)
                else:
                    # sweedlint: ok blocking-under-lock admin-plane tier move on a sealed volume; the held lock is the exclusivity the backend swap needs
                    s3.upload_volume(bucket, key, local)  # multipart past one part
            except Exception:
                # the seal holds only once the upload committed
                self.read_only = was_read_only
                raise
            info = {"bucket": bucket, "key": key, "size": size}
            if backend:
                info["backend"] = backend  # the secrets stay in backend.toml
            else:
                # inline credentials (mode 0600): a cluster without
                # backend.toml keeps working, but -backend keeps them out of
                # the data directories
                info.update(endpoint=endpoint, access_key=access_key, secret_key=secret_key)
            # atomic and durable: a crash leaves the old state (no descriptor,
            # the .dat intact) or the new one, never a torn descriptor
            # sweedlint: ok blocking-under-lock descriptor commit point must exclude writers; faultpoint sleeps are test-only
            faultpoints.fire("tier.upload.descriptor", path=local)
            # sweedlint: ok blocking-under-lock descriptor commit point must exclude writers (docs/CRASH.md)
            atomic_write(self.tier_file(), json.dumps(info).encode(), mode=0o600)
            # sweedlint: ok blocking-under-lock descriptor commit point must exclude writers; faultpoint sleeps are test-only
            faultpoints.fire("tier.upload.committed", path=self.tier_file())
            self.data_backend.close()
            # sweedlint: ok blocking-under-lock admin-plane tier move on a sealed volume; the held lock is the exclusivity the backend swap needs
            self.data_backend = RemoteS3File(endpoint, bucket, key, access_key, secret_key,
                                             size=size)
            if not keep_local:
                # sweedlint: ok durability past the .tier commit point; a crash leaves a harmless local copy
                os.unlink(local)  # past the commit point: a crash leaves a spare copy
            return {k: v for k, v in info.items() if k not in ("access_key", "secret_key")}

    def tier_download(self, access_key: str = "", secret_key: str = "") -> None:
        """Fetch the .dat back from the remote tier
        (volume_grpc_tier_download.go). Two-phase: the fetched .dat stages
        as a temporary and the descriptor's removal rides the commit
        manifest, so a crash leaves the volume fully tiered (the staged bytes
        collected at restart) or fully local."""
        with self._lock:
            with open(self.tier_file()) as f:
                info = json.load(f)
            endpoint, ak, sk = self._tier_credentials(info)
            s3 = S3BackendStorage(endpoint, access_key or ak, secret_key or sk,
                                  name=info.get("backend", ""))
            local = self.file_name() + ".dat"
            sc = StagedCommit(self.file_name(), "tier.download")
            tmp = sc.stage(local)
            sc.remove_on_commit(self.tier_file())
            try:
                # sweedlint: ok blocking-under-lock admin-plane tier move on a sealed volume; the held lock is the exclusivity the backend swap needs
                got = s3.download_volume(info["bucket"], info["key"], tmp)
                # sweedlint: ok blocking-under-lock descriptor commit point must exclude writers; faultpoint sleeps are test-only
                faultpoints.fire("tier.download.fetched", path=tmp)
                if got != info["size"]:
                    raise VolumeError(f"tier download: got {got} bytes, want {info['size']}")
                # sweedlint: ok blocking-under-lock two-phase commit point; exclusivity is the crash-safety contract
                sc.commit()
            except Exception:
                sc.abort()
                raise
            self.data_backend.close()
            self.data_backend = DiskFile(local)

    # -- lifecycle -----------------------------------------------------------
    def sync(self) -> None:
        with self._lock:
            if self.turbo is not None:
                self.turbo.sync(self.id)
                return
            # sweedlint: ok blocking-under-lock Volume.sync IS the durability primitive; callers hold the lock for write→fsync→ack ordering
            self.data_backend.sync()
            self.nm.sync()

    def close(self) -> None:
        self.detach_turbo(reload_map=False)
        with self._lock:
            self.nm.close()
            self.data_backend.close()

    def destroy(self) -> None:
        """Remove every file of this volume (volume_read_write.go:46-72).

        The ``.vif`` stays while an ``.ecx`` of the same base sits beside
        it: the EC volume made from this one owns the file then, and its
        scrub checks the shard sums in it (the JAX package removes it)."""
        with self._lock:
            if self._is_compacting:
                raise VolumeError(f"volume {self.id} is compacting")
            self.close()
            base = self.file_name()
            exts = [".dat", ".tier", ".idx", ".sdx", ".cpd", ".cpx", ".note",
                    ".ldb", ".mdx", ".mdx.meta"]
            if not os.path.exists(base + ".ecx"):
                exts.append(".vif")
            # .tier too: a deleted tiered volume must not load again at the
            # next start (the JAX package's destroy leaves its descriptor)
            for ext in exts:
                try:
                    # sweedlint: ok durability destroy path; deletion is the goal, FileNotFoundError makes re-runs idempotent
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
