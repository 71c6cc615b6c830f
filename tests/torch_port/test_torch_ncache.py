"""The port's hot-needle cache (``util/needle_cache.py``) against the JAX
package's: the same operations give the same answers and counters, and on a
live volume server a hit is the bytes a disk read gives, ``/admin/ncache``
resizes it, and writes and deletes invalidate it.

The live cases run with ``SWEED_TURBO=0`` in both packages: the cache sits
in the Python GET path, which the native engine bypasses.
"""

import random
import threading
import time

import pytest

from seaweedfs_tpu.util.needle_cache import NeedleCache as JCache
from seaweedfs_tpu_torch.util.needle_cache import NeedleCache as PCache
from seaweedfs_tpu_torch.util.needle_cache import _Shard, ncache_stats
from serving_pair import KINDS, both, pair, request

CACHES = {"jax": JCache, "port": PCache}


def _trace(cls):
    """A seeded sequence of gets, puts, invalidations and resizes; returns
    every answer and the stats after each step."""
    rng = random.Random(5)
    c = cls(capacity_bytes=4096, shards=4)
    out = []
    for step in range(600):
        vid, nid, cookie = rng.randint(1, 2), rng.randint(0, 40), rng.choice((7, 7, 7, 9))
        op = rng.random()
        if op < 0.45:
            out.append(("get", c.get(vid, nid, cookie)))
        elif op < 0.85:
            out.append(("put", c.put(vid, nid, cookie, bytes([nid]) * rng.randint(1, 300))))
        elif op < 0.97:
            out.append(("inv", c.invalidate(vid, nid)))
        else:
            c.set_capacity(rng.choice((0, 1024, 4096, 8192)))
            out.append(("cap", c.capacity, c.enabled))
        if step % 50 == 0:
            out.append(("stats", c.stats(), c.would_cache(200), c.would_cache(3000)))
    return out


def test_same_answers_as_the_reference():
    # shard choice is hash((vid, nid)): the same in both, in one process
    assert _trace(PCache) == _trace(JCache)


@pytest.mark.parametrize("kind", KINDS)
def test_hit_miss_cookie(kind):
    c = CACHES[kind](capacity_bytes=1 << 20)
    assert c.get(1, 10, 0xAB) is None
    c.put(1, 10, 0xAB, b"payload")
    assert c.get(1, 10, 0xAB) == b"payload"
    assert c.get(1, 10, 0xCD) is None  # a wrong cookie misses, the entry stays
    assert c.get(1, 10, 0xAB) == b"payload"
    c.invalidate(1, 10)
    assert c.get(1, 10, 0xAB) is None
    st = c.stats()
    assert st["hits"] == 2 and st["misses"] == 3 and st["hit_ratio"] == pytest.approx(0.4)


def test_disabled_resize_and_eviction():
    c = PCache()
    assert not c.enabled
    c.put(1, 1, 1, b"x")
    assert c.get(1, 1, 1) is None and c.stats()["misses"] == 0
    c.set_capacity(1 << 16)
    c.put(1, 1, 1, b"x")
    assert c.get(1, 1, 1) == b"x"
    c.set_capacity(0)
    assert c.stats()["entries"] == 0 and not c.enabled
    c = PCache(capacity_bytes=1600, shards=1)
    for i in range(100):
        c.put(1, i, 7, bytes(100))
    st = c.stats()
    assert (st["bytes"], st["entries"], st["evictions"]) == (1600, 16, 84)
    assert c.get(1, 99, 7) is not None and c.get(1, 0, 7) is None
    assert not c.would_cache(1601)
    assert ncache_stats()["entries"] >= 16


def test_concurrent_resize_stays_coherent(monkeypatch):
    orig = _Shard.resize
    monkeypatch.setattr(_Shard, "resize", lambda self, cap: (time.sleep(0.0005), orig(self, cap)))
    c = PCache(capacity_bytes=1 << 20, shards=32)
    for _ in range(3):
        barrier = threading.Barrier(2)

        def resize(cap):
            barrier.wait()
            c.set_capacity(cap)

        ts = [threading.Thread(target=resize, args=(cap,)) for cap in (1 << 20, 2 << 20)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert all(s.capacity == c.capacity // 32 for s in c._shards)


def test_live_cache_on_both_servers(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("SWEED_TURBO", "0")
    monkeypatch.setenv("SWEED_NCACHE", str(1 << 20))
    with pair(tmp_path_factory) as nodes:
        for n in nodes.values():
            assert n.vs.turbo is None and n.vs.ncache.enabled
        fid, body = "3,0a00001234", b"hot needle payload " * 10
        assert both(nodes, "POST", "/" + fid, body)["port"][0] == 201
        first = both(nodes, "GET", "/" + fid)  # a miss populates
        second = both(nodes, "GET", "/" + fid)  # a hit
        assert first["port"] == first["jax"] == second["port"] == second["jax"]
        assert first["port"][2] == body
        # the hit is the bytes the disk holds
        from seaweedfs_tpu_torch.storage.needle import Needle

        n = Needle(id=0xA)
        nodes["port"].vs.store.find_volume(3).read_needle(n)
        # (the same lookup on both caches keeps their counters in step)
        assert nodes["port"].vs.ncache.get(3, 0xA, 0x1234) == n.data == body
        assert nodes["jax"].vs.ncache.get(3, 0xA, 0x1234) == body
        ranged = both(nodes, "GET", "/" + fid, headers={"Range": "bytes=4-9"})
        assert ranged["port"] == ranged["jax"] and ranged["port"][2] == body[4:10]
        wrong = both(nodes, "GET", "/3,0a00009999")
        assert wrong["port"] == wrong["jax"] and wrong["port"][0] == 404
        for k, n in nodes.items():
            st = n.vs.ncache.stats()
            assert st["hits"] >= 2 and st["entries"] == 1, (k, st)
        # an overwrite invalidates
        assert both(nodes, "POST", "/" + fid, b"fresh bytes")["port"][0] == 201
        fresh = both(nodes, "GET", "/" + fid)
        assert fresh["port"] == fresh["jax"] and fresh["port"][2] == b"fresh bytes"
        # a delete invalidates
        assert both(nodes, "DELETE", "/" + fid)["port"][0] == 202
        gone = both(nodes, "GET", "/" + fid)
        assert gone["port"][0] == gone["jax"][0] == 404
        # resize through the admin route, same answers
        for cap in (0, 65536):
            r = both(nodes, "POST", f"/admin/ncache?capacity={cap}")
            assert r["port"][2] == r["jax"][2]
        r = both(nodes, "POST", "/admin/ncache", b'{"capacity": 4096}')
        assert r["port"][2] == r["jax"][2] and b'"capacity": 4096' in r["port"][2]
        bad = both(nodes, "POST", "/admin/ncache?capacity=zz")
        assert bad["port"][0] == bad["jax"][0] == 400
        st = request(nodes["port"].url, "GET", "/status")[2]
        assert b'"ncache": {"enabled": true, "capacity": 4096' in st
