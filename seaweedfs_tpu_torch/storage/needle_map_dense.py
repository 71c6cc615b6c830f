"""The ``dense`` needle map kind: 16 bytes an entry.

A volume's needle index has to fit in RAM at 16 bytes an entry
(`weed/storage/needle_map/compact_map.go:173`, sectioned sorted arrays + an
overflow map). ``DenseNeedleMap`` keeps parallel numpy arrays (key u64 +
scaled offset u32 + size i32 = 16 B; the 5-byte-offset flavour adds a u8
high-byte plane): a sorted base plus a small overflow dict for new keys,
merged in batches. Loading a .idx is vectorized (no per-entry Python).

The reference's other kinds (`sqlite`, `sorted`, `mmap`) are not ported.
"""

from __future__ import annotations

import io
import threading
from typing import BinaryIO, Callable, Iterator, Optional

import numpy as np

from .needle_map import IdxLogMixin, NeedleMapper, NeedleValue
from .types import (
    NEEDLE_PADDING_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    needle_map_entry_size,
    size_is_valid,
)


def _parse_idx_arrays(raw: bytes, offset_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized .idx parse → (keys u64, scaled offsets u64, sizes i64)."""
    entry = needle_map_entry_size(offset_size)
    n = len(raw) // entry
    a = np.frombuffer(raw[: n * entry], dtype=np.uint8).reshape(n, entry)
    keys = a[:, :8].copy().view(">u8").ravel().astype(np.uint64)
    offs = a[:, 8:12].copy().view(">u4").ravel().astype(np.uint64)
    if offset_size == 5:
        # 5-byte flavour: 4 low bytes big-endian + the most significant byte
        offs |= a[:, 12].astype(np.uint64) << np.uint64(32)
    sizes = (a[:, 8 + offset_size : 12 + offset_size].copy()
             .view(">i4").ravel().astype(np.int64))
    return keys, offs, sizes


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
