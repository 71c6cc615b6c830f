"""Tiered chunk cache (reference `util/chunk_cache/chunk_cache.go:16,41,90`):
an in-memory LRU for small chunks plus size-classed on-disk tiers (the
reference backs these with volume files; here: flat files under a cache dir,
LRU-evicted by byte budget). Used by the filer read path to keep hot chunks
off the volume servers (`filer/reader_at.go:35`).

The port's copy of the JAX package's ``util/chunk_cache.py``.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Optional
from .locks import make_lock


class MemoryChunkCache:
    def __init__(self, budget_bytes: int = 64 * 1024 * 1024):
        self.budget = budget_bytes
        self._lru: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0
        self._lock = make_lock("MemoryChunkCache._lock")
        self.hits = 0
        self.misses = 0

    def get(self, fid: str) -> Optional[bytes]:
        with self._lock:
            data = self._lru.get(fid)
            if data is None:
                self.misses += 1
                return None
            self._lru.move_to_end(fid)
            self.hits += 1
            return data

    def put(self, fid: str, data: bytes) -> None:
        with self._lock:
            if fid in self._lru:
                self._bytes -= len(self._lru.pop(fid))
            self._lru[fid] = data
            self._bytes += len(data)
            while self._bytes > self.budget and self._lru:
                _, evicted = self._lru.popitem(last=False)
                self._bytes -= len(evicted)


class DiskChunkCache:
    """Size-classed spill tier. One file per chunk, fid-hashed name; evicts
    oldest-mtime files once over budget (the reference reuses volume-file
    machinery per 1×/4×/16× unit class — same role, simpler store).

    A running byte total makes ``put`` O(1): the tree walk that used to run
    on EVERY put now runs once at startup (cold-cache inventory) and again
    only when the running total crosses the budget. ``get`` touches the
    file's mtime so eviction order is true LRU, not insertion order."""

    def __init__(self, directory: str, budget_bytes: int = 1024 * 1024 * 1024):
        self.dir = directory
        self.budget = budget_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = make_lock("DiskChunkCache._lock")
        self.hits = 0
        self.misses = 0
        self._bytes = self._walk_bytes()

    def _path(self, fid: str) -> str:
        h = hashlib.sha1(fid.encode()).hexdigest()
        return os.path.join(self.dir, h[:2], h[2:])

    def _walk_bytes(self) -> int:
        total = 0
        for root, _, names in os.walk(self.dir):
            for n in names:
                try:
                    total += os.stat(os.path.join(root, n)).st_size
                except FileNotFoundError:
                    continue
        return total

    def get(self, fid: str) -> Optional[bytes]:
        p = self._path(fid)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            return None
        try:
            # mtime is the LRU clock _evict sorts by: a read must refresh
            # it or a hot chunk written long ago is the first one evicted
            os.utime(p)
        except OSError:
            pass  # already-evicted race; the data is still good
        with self._lock:
            self.hits += 1
        return data

    def put(self, fid: str, data: bytes) -> None:
        p = self._path(fid)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            old = os.stat(p).st_size
        except FileNotFoundError:
            old = 0
        os.replace(tmp, p)
        with self._lock:
            self._bytes += len(data) - old
            if self._bytes > self.budget:
                self._evict_locked()

    def _evict_locked(self) -> None:
        """Walk + LRU-unlink down to budget. Only reached when the running
        total says we are over, so the O(n) walk is paid per overflow, not
        per put; the walk also resyncs the running total against ground
        truth (external deletions, crashed tmp files)."""
        entries = []
        total = 0
        for root, _, names in os.walk(self.dir):
            for n in names:
                p = os.path.join(root, n)
                try:
                    st = os.stat(p)
                except FileNotFoundError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        self._bytes = total
        if total <= self.budget:
            return
        entries.sort()
        for _, size, p in entries:
            try:
                os.unlink(p)
            except FileNotFoundError:
                continue
            self._bytes -= size
            if self._bytes <= self.budget:
                break


class TieredChunkCache:
    """Memory for chunks ≤ `mem_limit`, disk for anything ≤ `disk_limit`."""

    def __init__(
        self,
        directory: Optional[str] = None,
        mem_budget: int = 64 * 1024 * 1024,
        disk_budget: int = 1024 * 1024 * 1024,
        mem_limit: int = 4 * 1024 * 1024,
        disk_limit: int = 64 * 1024 * 1024,
    ):
        self.mem = MemoryChunkCache(mem_budget)
        self.disk = DiskChunkCache(directory, disk_budget) if directory else None
        self.mem_limit = mem_limit
        self.disk_limit = disk_limit

    def get(self, fid: str) -> Optional[bytes]:
        data = self.mem.get(fid)
        if data is not None:
            return data
        if self.disk is not None:
            data = self.disk.get(fid)
            if data is not None and len(data) <= self.mem_limit:
                self.mem.put(fid, data)  # promote
            return data
        return None

    def stats(self) -> dict:
        """Per-tier hit/miss counters for the filer /_status payload."""
        return {
            "hits": self.mem.hits,
            "misses": self.mem.misses,
            "disk_hits": self.disk.hits if self.disk else 0,
            "disk_misses": self.disk.misses if self.disk else 0,
        }

    def put(self, fid: str, data: bytes) -> None:
        if len(data) <= self.mem_limit:
            self.mem.put(fid, data)
        elif self.disk is not None and len(data) <= self.disk_limit:
            self.disk.put(fid, data)
