"""Needle maps: per-volume NeedleId → (offset, size) index.

Mirrors `weed/storage/needle_map.go` + `needle_map_memory.go`: every mutation
is also appended to the .idx file (the map's durable log); deletes append a
(key, tombstone_offset, -1) entry. Counters match the reference's mapMetric
(`needle_map_metric.go`): FileCount counts every put ever applied (overwrites
included), DeletionCounter counts explicit deletes and overwrite-shadowed
needles.

``CompactNeedleMap`` is the ``memory`` kind (a dict); the ``dense`` kind,
16 bytes an entry, is in needle_map_dense.py.
"""

from __future__ import annotations

import io
import os
import threading
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator, Optional

from . import idx as idx_mod
from .types import OFFSET_SIZE, TOMBSTONE_FILE_SIZE, size_is_valid


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # actual byte offset
    size: int


class NeedleMapper:
    """Interface (needle_map.go:21-34)."""

    def put(self, key: int, offset: int, size: int) -> None:
        raise NotImplementedError

    def get(self, key: int) -> Optional[NeedleValue]:
        raise NotImplementedError

    def delete(self, key: int, offset: int) -> None:
        raise NotImplementedError

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        raise NotImplementedError

    def release(self) -> None:
        """Drop auxiliary resources without closing the shared .idx file
        (called before the owner swaps in a fresh map over the same index
        handle). No-op for the in-memory kinds."""

    def close(self) -> None:
        pass

    def destroy(self) -> None:
        """Close and remove the map's own files (not the .idx)."""


class IdxLogMixin:
    """The .idx append log + mapMetric counters shared by the map kinds."""

    def _init_log(self, index_file: BinaryIO, offset_size: int) -> None:
        self._index_file = index_file
        self._offset_size = offset_size
        self.file_counter = 0
        self.file_byte_counter = 0
        self.deletion_counter = 0
        self.deletion_byte_counter = 0
        self.max_file_key = 0

    def _append_entry(self, key: int, offset: int, size: int) -> None:
        entry = idx_mod.pack_entry(key, offset, size, self._offset_size)
        self._index_file.seek(0, io.SEEK_END)
        self._index_file.write(entry)

    def content_size(self) -> int:
        return self.file_byte_counter

    def deleted_size(self) -> int:
        return self.deletion_byte_counter

    def file_count(self) -> int:
        return self.file_counter

    def deleted_count(self) -> int:
        return self.deletion_counter

    def _fileno(self) -> Optional[int]:
        """The .idx log's descriptor; None for an in-memory log
        (``io.BytesIO``)."""
        try:
            return self._index_file.fileno()
        except (AttributeError, io.UnsupportedOperation):
            return None

    def index_file_size(self) -> int:
        """Bytes in the .idx log: compaction's snapshot point and the end of
        its replay (an in-memory log is measured by seeking)."""
        fd = self._fileno()
        if fd is not None:
            return os.fstat(fd).st_size
        self._index_file.seek(0, io.SEEK_END)
        return self._index_file.tell()

    def sync(self) -> None:
        """Flush and fsync the .idx log; a failed fsync raises, so a write
        that asked for durability fails with it."""
        self._index_file.flush()
        fd = self._fileno()
        if fd is not None:
            os.fsync(fd)

    def close(self) -> None:
        self._index_file.close()


class CompactNeedleMap(IdxLogMixin, NeedleMapper):
    """In-memory map + .idx append log (the ``memory`` kind)."""

    def __init__(self, index_file: BinaryIO, offset_size: int = OFFSET_SIZE):
        self._m: dict[int, tuple[int, int]] = {}
        self._lock = threading.Lock()
        self._init_log(index_file, offset_size)

    # -- loading (needle_map_memory.go:30-51) --------------------------------
    @classmethod
    def load(cls, index_file: BinaryIO, offset_size: int = OFFSET_SIZE) -> "CompactNeedleMap":
        nm = cls(index_file, offset_size)
        for key, offset, size in idx_mod.iter_index_file(index_file, offset_size):
            nm.max_file_key = max(nm.max_file_key, key)
            old = nm._m.get(key)
            if offset != 0 and size_is_valid(size):
                nm.file_counter += 1
                nm.file_byte_counter += size
                nm._m[key] = (offset, size)
                if old is not None and old[0] != 0 and size_is_valid(old[1]):
                    nm.deletion_counter += 1
                    nm.deletion_byte_counter += old[1]
            else:
                nm.deletion_counter += 1
                if old is not None and size_is_valid(old[1]):
                    nm.deletion_byte_counter += old[1]
                    # deleted in place, keeping the original offset
                    # (compact_map.go Delete negates Size); absent keys are
                    # a no-op
                    nm._m[key] = (old[0], -old[1])
        index_file.seek(0, io.SEEK_END)
        return nm

    # -- mutations -----------------------------------------------------------
    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            old = self._m.get(key)
            self._m[key] = (offset, size)
            self.max_file_key = max(self.max_file_key, key)
            self.file_counter += 1
            self.file_byte_counter += size
            if old is not None and old[0] != 0 and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
            self._append_entry(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._m.get(key)
        if v is None:
            return None
        return NeedleValue(key, v[0], v[1])

    def delete(self, key: int, offset: int) -> None:
        """``offset`` is where the tombstone needle went in the .dat. The map
        keeps the original offset with a negated size; only the .idx log
        records the tombstone offset."""
        with self._lock:
            old = self._m.get(key)
            if old is not None and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
                self._m[key] = (old[0], -old[1])
            self._append_entry(key, offset, TOMBSTONE_FILE_SIZE)

    # -- queries -------------------------------------------------------------
    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for key in sorted(self._m):
            offset, size = self._m[key]
            fn(NeedleValue(key, offset, size))

    def items(self) -> Iterator[NeedleValue]:
        for key, (offset, size) in self._m.items():
            yield NeedleValue(key, offset, size)

    def __len__(self) -> int:
        return len(self._m)
