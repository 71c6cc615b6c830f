"""Needle map kinds beyond the dict: ``dense``, ``sqlite``, ``sorted``, ``mmap``.

A volume's needle index has to fit in RAM at 16 bytes an entry
(`weed/storage/needle_map/compact_map.go:173`, sectioned sorted arrays + an
overflow map). The kinds here (needle_map.go:12-19):

- ``DenseNeedleMap`` keeps parallel numpy arrays (key u64 + scaled offset
  u32 + size i32 = 16 B; the 5-byte-offset flavour adds a u8 high-byte
  plane): a sorted base plus a small overflow dict for new keys, merged in
  batches. Loading a .idx is vectorized (no per-entry Python).
- ``SqliteNeedleMap``, the LevelDB kind (`needle_map_leveldb.go:26`):
  entries in a SQLite B-tree beside the volume (``<volume>.ldb``) for
  indexes too big for RAM; the counters persist in a meta table, so a clean
  load is O(1), and a load whose meta is out of date replays the .idx.
- ``SortedFileNeedleMap``, the read-only kind
  (`needle_map_sorted_file.go:19`): binary search of a key-sorted index
  file (``<volume>.sdx``) on disk, no resident entries; for sealed volumes.
- ``MmapNeedleMap``: the same key-sorted format memory-mapped read-only
  (``<volume>.mdx``), mutations shadowing it in an overflow dict and merged
  by rewriting the file, with a JSON sidecar for the counters.

Every file here has the JAX package's format, so either package loads what
the other wrote.
"""

from __future__ import annotations

import io
import json
import mmap
import os
import threading
from typing import BinaryIO, Callable, Iterator, Optional

import numpy as np

from . import idx as idx_mod
from .needle_map import IdxLogMixin, NeedleMapper, NeedleValue
from .types import (
    NEEDLE_PADDING_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    needle_map_entry_size,
    size_is_valid,
)

# sqlite binds signed 64-bit ints only; needle keys are full u64, so keys
# are stored shifted by 2^63, which keeps their order
_KEY_BIAS = 1 << 63


def _parse_entry_matrix(a: np.ndarray, offset_size: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, entry) uint8 rows -> (keys u64, scaled offsets u64, sizes i64);
    only the sliced columns are copied, so ``a`` may be a memmap."""
    keys = a[:, :8].copy().view(">u8").ravel().astype(np.uint64)
    offs = a[:, 8:12].copy().view(">u4").ravel().astype(np.uint64)
    if offset_size == 5:
        # 5-byte flavour: 4 low bytes big-endian + the most significant byte
        offs |= a[:, 12].astype(np.uint64) << np.uint64(32)
    sizes = (a[:, 8 + offset_size : 12 + offset_size].copy()
             .view(">i4").ravel().astype(np.int64))
    return keys, offs, sizes


def _parse_idx_arrays(raw: bytes, offset_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized .idx parse -> (keys u64, scaled offsets u64, sizes i64)."""
    entry = needle_map_entry_size(offset_size)
    n = len(raw) // entry
    a = np.frombuffer(raw[: n * entry], dtype=np.uint8).reshape(n, entry)
    return _parse_entry_matrix(a, offset_size)


def _pack_entries(keys: np.ndarray, scaled_offs: np.ndarray, sizes: np.ndarray,
                  offset_size: int) -> np.ndarray:
    """The inverse of _parse_entry_matrix: (n, entry) uint8 rows equal to a
    pack_entry loop's bytes."""
    n = len(keys)
    a = np.empty((n, needle_map_entry_size(offset_size)), dtype=np.uint8)
    a[:, :8] = np.ascontiguousarray(keys, dtype=np.uint64).astype(">u8").view(
        np.uint8).reshape(n, 8)
    so = np.ascontiguousarray(scaled_offs, dtype=np.uint64)
    a[:, 8:12] = (so & np.uint64(0xFFFFFFFF)).astype(">u4").view(np.uint8).reshape(n, 4)
    if offset_size == 5:
        a[:, 12] = (so >> np.uint64(32)).astype(np.uint8)
    a[:, 8 + offset_size : 12 + offset_size] = np.ascontiguousarray(
        sizes, dtype=np.int64).astype(">i4").view(np.uint8).reshape(n, 4)
    return a


def replay_idx_vectorized(raw: bytes, offset_size: int):
    """Replay a whole .idx history without per-entry Python.

    Returns (metrics, final_keys u64 sorted, final_scaled_offs u64,
    final_sizes i64); metrics are the mapMetric counters with
    CompactNeedleMap's semantics: every put counts toward file_counter,
    overwrites and deletes of a live put count toward the deletion counters,
    and a key whose last action is a tombstone keeps its last put's offset
    with a negated size.
    """
    keys, offs, sizes = _parse_idx_arrays(raw, offset_size)
    n = len(keys)
    empty = np.empty(0, dtype=np.uint64)
    metrics = dict(file_counter=0, file_byte_counter=0, deletion_counter=0,
                   deletion_byte_counter=0, max_file_key=0)
    if n == 0:
        return metrics, empty, empty, np.empty(0, dtype=np.int64)
    puts = (offs != 0) & (sizes > 0)
    metrics["max_file_key"] = int(keys.max())
    metrics["file_counter"] = int(puts.sum())
    metrics["file_byte_counter"] = int(sizes[puts].sum())
    # a stable sort groups each key's entries in append order, so "the
    # previous state was a live put" is a shift within the run
    order = np.argsort(keys, kind="stable")
    k_s, p_s, sz_s, off_s = keys[order], puts[order], sizes[order], offs[order]
    same_prev = np.empty(n, dtype=bool)
    same_prev[0] = False
    same_prev[1:] = k_s[1:] == k_s[:-1]
    prev_valid = np.empty(n, dtype=bool)
    prev_valid[0] = False
    prev_valid[1:] = p_s[:-1]
    prev_valid &= same_prev
    # a delete always counts; a put over a live put shadows it
    metrics["deletion_counter"] = int((~p_s).sum() + (p_s & prev_valid).sum())
    prev_size = np.empty(n, dtype=np.int64)
    prev_size[0] = 0
    prev_size[1:] = sz_s[:-1]
    metrics["deletion_byte_counter"] = int(prev_size[prev_valid].sum())
    # final state per key: the last put wins; a later tombstone negates it
    starts = np.nonzero(~same_prev)[0]
    ends = np.concatenate([starts[1:], np.array([n])]) - 1
    put_idx = np.where(p_s, np.arange(n), -1)
    last_put = np.maximum.reduceat(put_idx, starts)
    has_put = last_put >= 0
    lp = last_put[has_put]
    fsizes = sz_s[lp]
    fsizes = np.where(ends[has_put] > lp, -fsizes, fsizes)
    return metrics, k_s[starts[has_put]].copy(), off_s[lp].copy(), fsizes


class DenseNeedleMap(IdxLogMixin, NeedleMapper):
    """16 B/entry packed in-memory kind (compact_map.go analog)."""

    MERGE_THRESHOLD = 8192
    # the overflow may also grow to base/MERGE_RATIO before merging, so a
    # sustained insert storm pays amortized O(1) array work per insert
    MERGE_RATIO = 8

    def __init__(self, index_file: BinaryIO, offset_size: int = OFFSET_SIZE):
        self._lock = threading.Lock()
        self._init_log(index_file, offset_size)
        self._keys = np.empty(0, dtype=np.uint64)  # sorted, unique
        self._offs = np.empty(0, dtype=np.uint32)  # scaled (/8)
        self._offs_hi = np.empty(0, dtype=np.uint8) if offset_size == 5 else None
        self._sizes = np.empty(0, dtype=np.int32)
        # the overflow holds only keys NOT in the base (updates to base keys
        # go in place), so a lookup checks it first and a merge is a union
        self._overflow: dict[int, tuple[int, int]] = {}

    def _merge_trigger(self) -> int:
        return max(self.MERGE_THRESHOLD, len(self._keys) // self.MERGE_RATIO)

    @classmethod
    def load(cls, index_file: BinaryIO, offset_size: int = OFFSET_SIZE) -> "DenseNeedleMap":
        nm = cls(index_file, offset_size)
        index_file.seek(0)
        raw = index_file.read()
        index_file.seek(0, io.SEEK_END)
        metrics, fkeys, foffs, fsizes = replay_idx_vectorized(raw, offset_size)
        nm.__dict__.update(metrics)
        nm._keys = fkeys
        nm._offs = foffs.astype(np.uint32)
        if nm._offs_hi is not None:
            nm._offs_hi = (foffs >> np.uint64(32)).astype(np.uint8)
        nm._sizes = fsizes.astype(np.int32)
        return nm

    # -- internals -----------------------------------------------------------
    def _base_find(self, key: int) -> Optional[int]:
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return i
        return None

    def _base_value(self, i: int) -> tuple[int, int]:
        scaled = int(self._offs[i])
        if self._offs_hi is not None:
            scaled |= int(self._offs_hi[i]) << 32
        return scaled * NEEDLE_PADDING_SIZE, int(self._sizes[i])

    def _base_set(self, i: int, offset: int, size: int) -> None:
        scaled = offset // NEEDLE_PADDING_SIZE
        self._offs[i] = scaled & 0xFFFFFFFF
        if self._offs_hi is not None:
            self._offs_hi[i] = scaled >> 32
        self._sizes[i] = size

    def _current(self, key: int) -> Optional[tuple[int, int]]:
        v = self._overflow.get(key)
        if v is not None:
            return v
        i = self._base_find(key)
        return self._base_value(i) if i is not None else None

    def _merge_overflow(self) -> None:
        ok = np.fromiter(self._overflow.keys(), dtype=np.uint64, count=len(self._overflow))
        vals = list(self._overflow.values())
        ooff = np.array([v[0] // NEEDLE_PADDING_SIZE for v in vals], dtype=np.uint64)
        osz = np.array([v[1] for v in vals], dtype=np.int32)
        order = np.argsort(ok)
        ok, ooff, osz = ok[order], ooff[order], osz[order]
        pos = np.searchsorted(self._keys, ok)
        self._keys = np.insert(self._keys, pos, ok)
        self._offs = np.insert(self._offs, pos, (ooff & 0xFFFFFFFF).astype(np.uint32))
        if self._offs_hi is not None:
            self._offs_hi = np.insert(self._offs_hi, pos, (ooff >> np.uint64(32)).astype(np.uint8))
        self._sizes = np.insert(self._sizes, pos, osz)
        self._overflow.clear()

    # -- mutations (CompactNeedleMap's semantics) ----------------------------
    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            old = self._current(key)
            if key in self._overflow:
                self._overflow[key] = (offset, size)
            else:
                i = self._base_find(key)
                if i is not None:
                    self._base_set(i, offset, size)
                else:
                    self._overflow[key] = (offset, size)
                    if len(self._overflow) >= self._merge_trigger():
                        self._merge_overflow()
            self.max_file_key = max(self.max_file_key, key)
            self.file_counter += 1
            self.file_byte_counter += size
            if old is not None and old[0] != 0 and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
            self._append_entry(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._current(key)
        if v is None:
            return None
        return NeedleValue(key, v[0], v[1])

    def delete(self, key: int, offset: int) -> None:
        with self._lock:
            old = self._current(key)
            if old is not None and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
                if key in self._overflow:
                    self._overflow[key] = (old[0], -old[1])
                else:
                    self._sizes[self._base_find(key)] = -old[1]
            self._append_entry(key, offset, TOMBSTONE_FILE_SIZE)

    # -- queries -------------------------------------------------------------
    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self.items():
            fn(nv)

    def items(self) -> Iterator[NeedleValue]:
        """Every entry in ascending key order."""
        ov = sorted(self._overflow.items())
        oi = 0
        for bi in range(len(self._keys)):
            key = int(self._keys[bi])
            while oi < len(ov) and ov[oi][0] < key:
                k, (o, s) = ov[oi]
                yield NeedleValue(k, o, s)
                oi += 1
            off, size = self._base_value(bi)
            yield NeedleValue(key, off, size)
        for k, (o, s) in ov[oi:]:
            yield NeedleValue(k, o, s)

    def __len__(self) -> int:
        return len(self._keys) + len(self._overflow)


class SqliteNeedleMap(IdxLogMixin, NeedleMapper):
    """The on-disk kind for indexes larger than RAM (needle_map_leveldb.go).

    Entries live in a SQLite B-tree beside the volume (``<volume>.ldb``).
    The .idx append log stays the durable source of truth (EC encode, copy
    and rebuild read it): db commits wait for sync()/close(), and a load
    whose committed meta does not match the .idx size (a crash, a torn
    tail, a compaction) drops the entries and replays the .idx."""

    _META_KEYS = ("file_counter", "file_byte_counter", "deletion_counter",
                  "deletion_byte_counter", "max_file_key")

    def __init__(self, index_file: BinaryIO, db_path: str, offset_size: int = OFFSET_SIZE):
        import sqlite3

        self._lock = threading.Lock()
        self._init_log(index_file, offset_size)
        self._db_path = db_path
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute("CREATE TABLE IF NOT EXISTS needles"
                         " (key INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)")
        self._db.execute("CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)")

    @classmethod
    def load(cls, index_file: BinaryIO, db_path: str,
             offset_size: int = OFFSET_SIZE) -> "SqliteNeedleMap":
        nm = cls(index_file, db_path, offset_size)
        meta = {k: int(v) for k, v in nm._db.execute("SELECT k, v FROM meta")}
        if meta.get("idx_size", -1) == nm.index_file_size():
            for k in cls._META_KEYS:
                setattr(nm, k, int(meta.get(k, 0)))
        else:
            nm._rebuild_from_idx()
        index_file.seek(0, io.SEEK_END)
        return nm

    def _rebuild_from_idx(self) -> None:
        """Replay the .idx (db missing or out of date)."""
        self._db.execute("DELETE FROM needles")
        self._index_file.seek(0)
        metrics, fkeys, foffs, fsizes = replay_idx_vectorized(
            self._index_file.read(), self._offset_size)
        self.__dict__.update(metrics)
        actual = (foffs * np.uint64(NEEDLE_PADDING_SIZE)).astype(np.int64)
        # (key XOR 2^63) read as i64 is key - 2^63 for every u64 key
        skeys = (fkeys ^ np.uint64(_KEY_BIAS)).view(np.int64)
        self._db.executemany("INSERT INTO needles VALUES (?,?,?)",
                             zip(skeys.tolist(), actual.tolist(), fsizes.tolist()))
        self._commit_meta()
        self._db.commit()

    def _commit_meta(self) -> None:
        # as text: max_file_key is a full u64, past sqlite's signed binding
        self._db.executemany(
            "INSERT OR REPLACE INTO meta VALUES (?,?)",
            [(k, str(getattr(self, k))) for k in self._META_KEYS]
            + [("idx_size", str(self.index_file_size()))])

    @staticmethod
    def _sk(key: int) -> int:
        """u64 needle key -> signed 64-bit sqlite key (order kept)."""
        return key - _KEY_BIAS

    def _row(self, sk: int):
        return self._db.execute("SELECT offset, size FROM needles WHERE key=?",
                                (sk,)).fetchone()

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            sk = self._sk(key)
            row = self._row(sk)
            self._db.execute("INSERT OR REPLACE INTO needles VALUES (?,?,?)",
                             (sk, offset, size))
            self.max_file_key = max(self.max_file_key, key)
            self.file_counter += 1
            self.file_byte_counter += size
            if row is not None and row[0] != 0 and size_is_valid(row[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += row[1]
            self._append_entry(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        row = self._row(self._sk(key))
        return None if row is None else NeedleValue(key, row[0], row[1])

    def delete(self, key: int, offset: int) -> None:
        with self._lock:
            sk = self._sk(key)
            row = self._row(sk)
            if row is not None and size_is_valid(row[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += row[1]
                self._db.execute("UPDATE needles SET size=? WHERE key=?", (-row[1], sk))
            self._append_entry(key, offset, TOMBSTONE_FILE_SIZE)

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self.items():
            fn(nv)

    def items(self) -> Iterator[NeedleValue]:
        for skey, offset, size in self._db.execute(
                "SELECT key, offset, size FROM needles ORDER BY key"):
            yield NeedleValue(skey + _KEY_BIAS, offset, size)

    def __len__(self) -> int:
        return self._db.execute("SELECT COUNT(*) FROM needles").fetchone()[0]

    def sync(self) -> None:
        super().sync()
        with self._lock:
            self._commit_meta()
            self._db.commit()

    def release(self) -> None:
        self._db.close()

    def close(self) -> None:
        # the meta before the .idx closes: it records the .idx's size (the
        # JAX package's order fails there and leaves the db open, its WAL
        # beside the volume, and the next load replaying the .idx)
        try:
            with self._lock:
                self._commit_meta()
                self._db.commit()
            self._db.close()
        # sweedlint: ok broad-except shutdown close; the mmap flush above already made state durable
        except Exception:  # noqa: BLE001 — derived data; the next load replays the .idx
            pass
        super().close()

    def destroy(self) -> None:
        self.close()
        try:
            # sweedlint: ok durability destroy path; deletion is the goal and re-running is idempotent
            os.remove(self._db_path)
        except FileNotFoundError:
            pass


def _write_sorted_entries(keys: np.ndarray, scaled_offs: np.ndarray, sizes: np.ndarray,
                          sorted_path: str, offset_size: int) -> None:
    """Write key-sorted final-state entries atomically (tmp + rename)."""
    a = _pack_entries(keys, scaled_offs, sizes, offset_size)
    with open(sorted_path + ".tmp", "wb") as f:
        f.write(a.tobytes())
    # sweedlint: ok durability atomic tmp+rename of derived data; the sorted base rebuilds from .idx
    os.replace(sorted_path + ".tmp", sorted_path)


def write_sorted_index(idx_raw: bytes, sorted_path: str, offset_size: int = OFFSET_SIZE) -> None:
    """Replay an .idx history and write its final state key-sorted (.sdx),
    the input of the read-only kind (the .ecx's sibling,
    WriteSortedFileFromIdx in ec_encoder.go:27)."""
    _, fkeys, foffs, fsizes = replay_idx_vectorized(idx_raw, offset_size)
    _write_sorted_entries(fkeys, foffs, fsizes, sorted_path, offset_size)


class SortedFileNeedleMap(IdxLogMixin, NeedleMapper):
    """The read-only kind: binary search of a key-sorted index file on disk
    (needle_map_sorted_file.go:19). No resident entries; for sealed
    volumes, where even 16 B an entry is too much."""

    def __init__(self, sorted_path: str, offset_size: int = OFFSET_SIZE,
                 index_file: Optional[BinaryIO] = None):
        self._f = open(sorted_path, "rb")
        self._entry = needle_map_entry_size(offset_size)
        self._count = os.fstat(self._f.fileno()).st_size // self._entry
        self._lock = threading.Lock()
        self._init_log(index_file or self._f, offset_size)
        # the counters from one streaming pass (nothing stays resident)
        keys, _, sizes = _parse_idx_arrays(self._f.read(), offset_size)
        if len(keys):
            self.max_file_key = int(keys.max())
            live = sizes > 0
            self.file_counter = int(live.sum())
            self.file_byte_counter = int(sizes[live].sum())
            self.deletion_counter = int((~live).sum())
            self.deletion_byte_counter = int(-sizes[~live].sum())

    def _read(self, i: int) -> tuple[int, int, int]:
        with self._lock:
            self._f.seek(i * self._entry)
            return idx_mod.unpack_entry(self._f.read(self._entry), self._offset_size)

    def get(self, key: int) -> Optional[NeedleValue]:
        lo, hi = 0, self._count
        while lo < hi:
            mid = (lo + hi) // 2
            k, off, size = self._read(mid)
            if k == key:
                return NeedleValue(k, off, size)
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return None

    def put(self, key: int, offset: int, size: int) -> None:
        raise io.UnsupportedOperation("sorted-file needle map is read-only")

    def delete(self, key: int, offset: int) -> None:
        raise io.UnsupportedOperation("sorted-file needle map is read-only")

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self.items():
            fn(nv)

    def items(self) -> Iterator[NeedleValue]:
        for i in range(self._count):
            yield NeedleValue(*self._read(i))

    def __len__(self) -> int:
        return self._count

    def close(self) -> None:
        self._f.close()
        if self._index_file is not self._f:
            super().close()


class MmapNeedleMap(IdxLogMixin, NeedleMapper):
    """The memory-mapped kind, for indexes past RAM even at 16 B an entry.

    The base (``<volume>.mdx``) is the .idx's final state, key-sorted in the
    .sdx's format and mapped read-only (np.memmap): a get() binary-searches
    the mapping and faults in only the pages it touches. Mutations shadow
    the base in an overflow dict (a negative size marks a delete) and are
    merged by rewriting the file atomically, with DenseNeedleMap's
    ratio-amortized trigger.

    A JSON sidecar (``<volume>.mdx.meta``) pins the .idx size and the
    counters the base reflects, so a load maps the base without reading the
    .idx. A stale or missing sidecar replays the .idx. The .idx stays the
    durable source of truth; base and sidecar are derived data."""

    MERGE_THRESHOLD = 8192
    MERGE_RATIO = 8

    _META_KEYS = SqliteNeedleMap._META_KEYS

    def __init__(self, index_file: BinaryIO, base_path: str, offset_size: int = OFFSET_SIZE):
        self._lock = threading.Lock()
        self._init_log(index_file, offset_size)
        self._base_path = base_path
        self._meta_path = base_path + ".meta"
        self._entry = needle_map_entry_size(offset_size)
        self._mm: Optional[np.memmap] = None
        self._count = 0
        # the mapping is immutable: updates AND deletes of base keys live
        # here until the next merge
        self._overflow: dict[int, tuple[int, int]] = {}
        self.merge_count = 0  # merges since load

    @classmethod
    def load(cls, index_file: BinaryIO, base_path: str,
             offset_size: int = OFFSET_SIZE) -> "MmapNeedleMap":
        nm = cls(index_file, base_path, offset_size)
        meta = nm._read_meta()
        if (meta is not None
                and meta.get("idx_size") == nm.index_file_size()
                and meta.get("offset_size") == offset_size
                and os.path.exists(base_path)
                and os.path.getsize(base_path) == meta.get("count", -1) * nm._entry):
            for k in cls._META_KEYS:
                setattr(nm, k, int(meta.get(k, 0)))
            nm._map_base(int(meta["count"]))
        else:
            nm._rebuild_from_idx()
        index_file.seek(0, io.SEEK_END)
        return nm

    def _read_meta(self) -> Optional[dict]:
        try:
            with open(self._meta_path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_meta(self) -> None:
        meta = {k: getattr(self, k) for k in self._META_KEYS}
        meta["idx_size"] = self.index_file_size()
        meta["offset_size"] = self._offset_size
        meta["count"] = self._count
        with open(self._meta_path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(meta, f)
        # sweedlint: ok durability derived sidecar; a torn meta just forces an .idx replay on the next load
        os.replace(self._meta_path + ".tmp", self._meta_path)

    def _map_base(self, count: int) -> None:
        self._count = count
        if count == 0:
            # sweedlint: ok lock-discipline helper; callers hold the lock (put/delete/close) or run in load before the map is shared
            self._mm = None  # np.memmap refuses an empty file
            return
        # sweedlint: ok lock-discipline helper; callers hold the lock (put/delete/close) or run in load before the map is shared
        self._mm = np.memmap(self._base_path, dtype=np.uint8, mode="r",
                             shape=(count * self._entry,))
        # a binary search is random access: without MADV_RANDOM readahead
        # maps whole clusters a touched page, growing RSS toward the base
        # sweedlint: ok lock-discipline helper; callers hold the lock or run in load before the map is shared
        raw = getattr(self._mm, "_mmap", None)
        if raw is not None and hasattr(mmap, "MADV_RANDOM"):
            raw.madvise(mmap.MADV_RANDOM)

    def _rebuild_from_idx(self) -> None:
        self._index_file.seek(0)
        metrics, fkeys, foffs, fsizes = replay_idx_vectorized(
            self._index_file.read(), self._offset_size)
        self.__dict__.update(metrics)
        self._write_base(fkeys, foffs, fsizes)

    def _write_base(self, keys: np.ndarray, scaled_offs: np.ndarray, sizes: np.ndarray) -> None:
        # drop the mapping before the rename; one another thread still
        # holds stays valid (the replaced inode lives until unmapped)
        # sweedlint: ok lock-discipline helper; callers (put/delete/close/load) serialize through the lock
        self._mm = None
        _write_sorted_entries(keys, scaled_offs, sizes, self._base_path, self._offset_size)
        self._map_base(len(keys))
        self._write_meta()

    # -- base lookups (under the caller's lock) ------------------------------
    def _key_at(self, i: int) -> int:
        s = i * self._entry
        # sweedlint: ok lock-discipline read helper under the caller's lock (get/put/delete)
        return int.from_bytes(self._mm[s : s + 8].tobytes(), "big")

    def _entry_at(self, i: int) -> tuple[int, int, int]:
        s = i * self._entry
        # sweedlint: ok lock-discipline read helper under the caller's lock (get/put/delete)
        return idx_mod.unpack_entry(self._mm[s : s + self._entry].tobytes(), self._offset_size)

    def _base_find(self, key: int) -> Optional[int]:
        lo, hi = 0, self._count
        while lo < hi:
            mid = (lo + hi) // 2
            k = self._key_at(mid)
            if k == key:
                return mid
            if k < key:
                lo = mid + 1
            else:
                hi = mid
        return None

    def _current(self, key: int) -> Optional[tuple[int, int]]:
        v = self._overflow.get(key)
        if v is not None:
            return v
        i = self._base_find(key)
        if i is None:
            return None
        _, off, size = self._entry_at(i)
        return off, size

    # -- mutations (CompactNeedleMap's semantics) ----------------------------
    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            old = self._current(key)
            self._overflow[key] = (offset, size)
            self.max_file_key = max(self.max_file_key, key)
            self.file_counter += 1
            self.file_byte_counter += size
            if old is not None and old[0] != 0 and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
            self._append_entry(key, offset, size)
            if len(self._overflow) >= max(self.MERGE_THRESHOLD, self._count // self.MERGE_RATIO):
                self._merge_overflow()

    def get(self, key: int) -> Optional[NeedleValue]:
        with self._lock:
            v = self._current(key)
        return None if v is None else NeedleValue(key, v[0], v[1])

    def delete(self, key: int, offset: int) -> None:
        with self._lock:
            old = self._current(key)
            if old is not None and size_is_valid(old[1]):
                self.deletion_counter += 1
                self.deletion_byte_counter += old[1]
                self._overflow[key] = (old[0], -old[1])
            self._append_entry(key, offset, TOMBSTONE_FILE_SIZE)

    def _merge_overflow(self) -> None:
        if not self._overflow:
            return
        if self._count:
            # sweedlint: ok lock-discipline merge runs under the put/close caller's lock
            a = np.asarray(self._mm).reshape(self._count, self._entry)
            bkeys, boffs, bsizes = _parse_entry_matrix(a, self._offset_size)
        else:
            bkeys = np.empty(0, dtype=np.uint64)
            boffs = np.empty(0, dtype=np.uint64)
            bsizes = np.empty(0, dtype=np.int64)
        ok = np.fromiter(self._overflow.keys(), dtype=np.uint64, count=len(self._overflow))
        vals = list(self._overflow.values())
        ooff = np.array([v[0] // NEEDLE_PADDING_SIZE for v in vals], dtype=np.uint64)
        osz = np.array([v[1] for v in vals], dtype=np.int64)
        order = np.argsort(ok)
        ok, ooff, osz = ok[order], ooff[order], osz[order]
        pos = np.searchsorted(bkeys, ok)
        hit = pos < len(bkeys)
        hit[hit] = bkeys[pos[hit]] == ok[hit]
        boffs[pos[hit]] = ooff[hit]
        bsizes[pos[hit]] = osz[hit]
        ins = ~hit
        bkeys = np.insert(bkeys, pos[ins], ok[ins])
        boffs = np.insert(boffs, pos[ins], ooff[ins])
        bsizes = np.insert(bsizes, pos[ins], osz[ins])
        self._overflow.clear()
        self._write_base(bkeys, boffs, bsizes)
        self.merge_count += 1

    # -- queries -------------------------------------------------------------
    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        for nv in self.items():
            fn(nv)

    def items(self) -> Iterator[NeedleValue]:
        """Every entry in ascending key order, the overflow shadowing the
        base."""
        ov = sorted(self._overflow.items())
        oi = 0
        for bi in range(self._count):
            key, off, size = self._entry_at(bi)
            while oi < len(ov) and ov[oi][0] < key:
                k, (o, sz) = ov[oi]
                yield NeedleValue(k, o, sz)
                oi += 1
            if oi < len(ov) and ov[oi][0] == key:
                k, (o, sz) = ov[oi]
                yield NeedleValue(k, o, sz)
                oi += 1
            else:
                yield NeedleValue(key, off, size)
        for k, (o, sz) in ov[oi:]:
            yield NeedleValue(k, o, sz)

    def __len__(self) -> int:
        shadowed = sum(1 for k in self._overflow if self._base_find(k) is not None)
        return self._count + len(self._overflow) - shadowed

    # -- lifecycle -----------------------------------------------------------
    def release(self) -> None:
        with self._lock:
            self._mm = None
            self._overflow.clear()

    def close(self) -> None:
        try:
            with self._lock:
                self._merge_overflow()
                self._write_meta()
                self._mm = None
        # sweedlint: ok broad-except shutdown close; base+meta are derived, the next load replays the .idx
        except Exception:  # noqa: BLE001 — derived data; the next load replays the .idx
            pass
        super().close()

    def destroy(self) -> None:
        self.close()
        for p in (self._base_path, self._meta_path):
            try:
                # sweedlint: ok durability destroy path; deletion is the goal and re-running is idempotent
                os.remove(p)
            except FileNotFoundError:
                pass
