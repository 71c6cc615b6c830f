"""Hot-needle RAM cache: a sharded LRU byte-cache keyed by fid.

The port's copy of the JAX package's ``util/needle_cache.py``. Zipfian GET
storms concentrate on a tiny head of needles; the aio core can accept the
storm but every request still pays a disk read (or a sendfile extent
setup). This tier sits in the volume server's GET path: a hit serves the
needle payload straight from RAM, a miss falls through unchanged to the
zero-copy sendfile extent or the buffered read.

Sharding bounds lock contention: the fid hash picks a shard, and each
shard is an independent ``OrderedDict`` LRU with its own lock and byte
budget, so concurrent GETs on different shards never serialize.  Entries
carry the needle cookie; a cookie mismatch is served as a miss (the
request would 404 on disk too, and the entry stays for the rightful fid).

The byte budget comes from ``SWEED_NCACHE`` (0 = disabled, the default)
and can be resized live through the volume server's POST /admin/ncache —
the hot-shard probe uses that to A/B the same cluster with the cache off
and on.  Writes and deletes invalidate through the server's mutation
handlers, so a hit is always the bytes a disk read would have returned.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Optional
from .locks import make_lock
from .racecheck import instrument


DEFAULT_SHARDS = 16


@instrument
class _Shard:
    """One LRU shard: key -> (cookie, payload), most-recent last."""

    __slots__ = ("_lock", "_entries", "_bytes", "capacity",
                 "hits", "misses", "evictions")

    def __init__(self) -> None:
        self._lock = make_lock("NeedleCache._Shard._lock")
        self._entries: "OrderedDict[tuple[int, int], tuple[int, bytes]]" = OrderedDict()
        self._bytes = 0
        self.capacity = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple[int, int], cookie: int) -> Optional[bytes]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or ent[0] != cookie:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[1]

    def put(self, key: tuple[int, int], cookie: int, data: bytes) -> None:
        with self._lock:
            if len(data) > self.capacity:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])
            self._entries[key] = (cookie, data)
            self._bytes += len(data)
            self._evict_locked()

    def invalidate(self, key: tuple[int, int]) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[1])

    def resize(self, capacity: int) -> None:
        with self._lock:
            self.capacity = capacity
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self._bytes > self.capacity and self._entries:
            _, (_, data) = self._entries.popitem(last=False)
            self._bytes -= len(data)
            self.evictions += 1

    def snapshot(self) -> tuple[int, int, int, int, int]:
        with self._lock:
            return (self.hits, self.misses, self.evictions,
                    self._bytes, len(self._entries))


@instrument
class NeedleCache:
    """Sharded LRU over needle payloads, keyed ``(vid, needle_id)``."""

    def __init__(self, capacity_bytes: int = 0, shards: int = DEFAULT_SHARDS):
        self._shards = [_Shard() for _ in range(shards)]
        self._capacity = 0
        self._resize_mu = make_lock("NeedleCache._resize_mu")
        self.set_capacity(capacity_bytes)
        _caches.add(self)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def enabled(self) -> bool:
        return self._capacity > 0

    def set_capacity(self, capacity_bytes: int) -> None:
        """Resize the total byte budget (0 disables); evicts immediately
        so a shrink takes effect without waiting for traffic.

        Serialized: an admin resize (handler thread) racing an autopilot
        resize (background thread) would otherwise interleave the
        per-shard loop and leave shard budgets mixed between the two
        totals — and ``_capacity`` agreeing with neither."""
        capacity_bytes = max(0, int(capacity_bytes))
        with self._resize_mu:
            self._capacity = capacity_bytes
            per_shard = capacity_bytes // len(self._shards)
            for s in self._shards:
                s.resize(per_shard)

    def would_cache(self, size: int) -> bool:
        """True when an entry of ``size`` bytes fits the per-shard budget —
        callers use this to skip materializing payloads the cache would
        refuse anyway."""
        return self._capacity > 0 and size <= self._capacity // len(self._shards)

    def _shard(self, vid: int, nid: int) -> _Shard:
        return self._shards[hash((vid, nid)) % len(self._shards)]

    def get(self, vid: int, nid: int, cookie: int) -> Optional[bytes]:
        if not self.enabled:
            return None
        return self._shard(vid, nid).get((vid, nid), cookie)

    def put(self, vid: int, nid: int, cookie: int, data: bytes) -> None:
        if not self.enabled:
            return
        self._shard(vid, nid).put((vid, nid), cookie, data)

    def invalidate(self, vid: int, nid: int) -> None:
        if not self.enabled:
            return
        self._shard(vid, nid).invalidate((vid, nid))

    def stats(self) -> dict:
        hits = misses = evictions = nbytes = entries = 0
        for s in self._shards:
            h, m, e, b, n = s.snapshot()
            hits += h
            misses += m
            evictions += e
            nbytes += b
            entries += n
        lookups = hits + misses
        return {
            "enabled": self.enabled,
            "capacity": self._capacity,
            "hits": hits,
            "misses": misses,
            "evictions": evictions,
            "bytes": nbytes,
            "entries": entries,
            "hit_ratio": round(hits / lookups, 4) if lookups else 0.0,
        }


# live caches register themselves so sweed_ncache_* gauges aggregate
# without stats holding servers alive (the _ServingState precedent)
_caches: "weakref.WeakSet" = weakref.WeakSet()


def ncache_stats() -> dict:
    hits = misses = evictions = nbytes = entries = 0
    for c in list(_caches):
        s = c.stats()
        hits += s["hits"]
        misses += s["misses"]
        evictions += s["evictions"]
        nbytes += s["bytes"]
        entries += s["entries"]
    lookups = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "evictions": evictions,
        "bytes": nbytes,
        "entries": entries,
        "hit_ratio": round(hits / lookups, 4) if lookups else 0.0,
    }
