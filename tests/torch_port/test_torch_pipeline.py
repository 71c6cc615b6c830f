"""``util/pipeline.py``, ``util/chunk_cache.py`` and ``util/hedge.py`` of
the port held against the JAX package's.

The JAX package's ``tests/test_pipeline.py`` cases run against both
packages' ``prefetch_iter`` and ``BoundedExecutor`` (``pl`` = either
module): ordered read-ahead, single-flight dedup, eager first error,
close-without-wait, bounded in-flight work; submit-order drain, blocking at
the window, fail-fast, settle-before-raise, abort. Then the same sequence of
puts and gets gives equal hits, misses and stats from either
``TieredChunkCache`` (memory only, and memory + disk), and ``hedged_call``
gives the same winners and counters for the same legs.
"""

from __future__ import annotations

import threading
import time

import pytest

from seaweedfs_tpu.util import chunk_cache as j_cache
from seaweedfs_tpu.util import hedge as j_hedge
from seaweedfs_tpu.util import pipeline as j_pipeline
from seaweedfs_tpu_torch.util import chunk_cache as p_cache
from seaweedfs_tpu_torch.util import hedge as p_hedge
from seaweedfs_tpu_torch.util import pipeline as p_pipeline


@pytest.fixture(params=["jax", "port"])
def pl(request):
    return {"jax": j_pipeline, "port": p_pipeline}[request.param]


# ---------------------------------------------------------------- prefetch


def test_prefetch_yields_in_input_order(pl):
    items = list(range(20))
    seen = list(pl.prefetch_iter(items, lambda i: i * i, window=4))
    assert seen == [(i, i * i) for i in items]


def test_prefetch_window_one_is_serial(pl):
    calls = []

    def fetch(i):
        calls.append(i)
        return i

    gen = pl.prefetch_iter([1, 2, 3], fetch, window=1)
    assert next(gen) == (1, 1)
    # serial path: nothing is fetched ahead of the consumer
    assert calls == [1]
    assert list(gen) == [(2, 2), (3, 3)]
    assert calls == [1, 2, 3]


def test_prefetch_order_survives_slow_fetch(pl):
    """A slow fetch for item k must not let k+1 overtake it."""

    def fetch(i):
        if i == 0:
            time.sleep(0.05)
        return i

    seen = [item for item, _ in pl.prefetch_iter(range(6), fetch, window=4)]
    assert seen == list(range(6))


def test_prefetch_single_flight_dedup(pl):
    """Interleaved views over the same fid (A,B,A,B) share one in-flight
    fetch per key instead of racing duplicates."""
    counts: dict = {}
    lock = threading.Lock()

    def fetch(item):
        k = item[0]
        with lock:
            counts[k] = counts.get(k, 0) + 1
        return k.upper()

    # key collides on the first tuple element; window spans the repeats
    items = [("a", 1), ("b", 2), ("a", 3), ("b", 4)]
    out = list(pl.prefetch_iter(items, fetch, window=4, key=lambda t: t[0]))
    assert out == [(i, i[0].upper()) for i in items]
    assert counts == {"a": 1, "b": 1}


def test_prefetch_dedup_refetches_after_window_passes(pl):
    """Dedup is single-flight, not a cache: once every pending view of a
    key has been yielded, a later view of the same key fetches again."""
    counts = {"a": 0}

    def fetch(item):
        counts["a"] += 1
        return counts["a"]

    # window=2 ⟹ the two "a" views are never pending together
    items = ["a", "x", "y", "z", "a"]
    out = list(pl.prefetch_iter(items, fetch, window=2, key=lambda s: s))
    assert out[0] == ("a", 1)
    assert out[-1][0] == "a" and out[-1][1] >= 2


def test_prefetch_error_propagates_at_position(pl):
    def fetch(i):
        if i == 2:
            raise ValueError("boom")
        return i

    gen = pl.prefetch_iter(range(5), fetch, window=4)
    assert next(gen) == (0, 0)
    assert next(gen) == (1, 1)
    with pytest.raises(ValueError, match="boom"):
        next(gen)


def test_prefetch_first_item_error_is_eager(pl):
    """Error on the very first item surfaces on the first next() — the
    filer's eager-first-piece semantics (500, not a truncated 200)."""

    def fetch(i):
        raise OSError("no volume")

    gen = pl.prefetch_iter([1, 2, 3], fetch, window=8)
    with pytest.raises(OSError, match="no volume"):
        next(gen)


def test_prefetch_close_does_not_block_on_inflight(pl):
    """Closing the generator mid-stream (client disconnect) must return
    promptly even while a fetch is wedged."""
    release = threading.Event()

    def fetch(i):
        if i > 0:
            release.wait(5)
        return i

    gen = pl.prefetch_iter(range(8), fetch, window=4)
    assert next(gen) == (0, 0)
    t0 = time.monotonic()
    gen.close()  # wedged fetches are still in flight
    assert time.monotonic() - t0 < 1.0
    release.set()


def test_prefetch_close_is_idempotent_and_stops_iteration(pl):
    gen = pl.prefetch_iter(range(100), lambda i: i, window=4)
    next(gen)
    gen.close()
    gen.close()
    with pytest.raises(StopIteration):
        next(gen)


def test_prefetch_bounds_inflight_fetches(pl):
    """No more than `window` fetches are started ahead of the consumer."""
    started = []
    lock = threading.Lock()
    gate = threading.Event()

    def fetch(i):
        with lock:
            started.append(i)
        gate.wait(5)
        return i

    gen = pl.prefetch_iter(range(50), fetch, window=3)
    # give the pool time to overfill if it were going to
    time.sleep(0.2)
    try:
        with lock:
            assert len(started) <= 3, started
    finally:
        gate.set()
        assert [i for i, _ in gen] == list(range(50))


# ---------------------------------------------------------- BoundedExecutor


def test_executor_drain_returns_submit_order(pl):
    pipe = pl.BoundedExecutor(window=4, name="t")

    def work(i):
        if i % 2 == 0:
            time.sleep(0.02)
        return i * 10

    for i in range(8):
        pipe.submit(work, i)
    assert pipe.drain() == [i * 10 for i in range(8)]


def test_executor_submit_blocks_at_window(pl):
    """The producer self-throttles: submit #window+1 blocks until a slot
    frees, capping resident data at window × chunk size."""
    gate = threading.Event()
    pipe = pl.BoundedExecutor(window=2, name="t")
    pipe.submit(gate.wait, 5)
    pipe.submit(gate.wait, 5)

    blocked = threading.Event()
    unblocked = threading.Event()

    def producer():
        blocked.set()
        pipe.submit(lambda: None)
        unblocked.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    assert blocked.wait(2)
    assert not unblocked.wait(0.2), "third submit should block at window=2"
    gate.set()
    assert unblocked.wait(2), "submit must unblock once a slot frees"
    pipe.drain()
    t.join(2)


def test_executor_failfast_submit_after_error(pl):
    pipe = pl.BoundedExecutor(window=2, name="t")

    def bad():
        raise RuntimeError("upload failed")

    pipe.submit(bad)
    # wait for the failure to land, then the next submit raises it
    deadline = time.monotonic() + 2
    while pipe._first_error is None and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="upload failed"):
        pipe.submit(lambda: None)
    pipe.abort()


def test_executor_drain_raises_after_all_settle(pl):
    """drain() raises the first error only after EVERY task settled, so
    the caller's purge sees the complete uploaded-fid set."""
    done = []
    all_submitted = threading.Event()

    def work(i):
        all_submitted.wait(5)
        if i == 1:
            raise ValueError("chunk 1 died")
        time.sleep(0.03)
        done.append(i)
        return i

    pipe = pl.BoundedExecutor(window=4, name="t")
    for i in range(4):
        pipe.submit(work, i)
    all_submitted.set()
    with pytest.raises(ValueError, match="chunk 1 died"):
        pipe.drain()
    assert sorted(done) == [0, 2, 3]


def test_executor_abort_settles_and_swallows(pl):
    done = []
    pipe = pl.BoundedExecutor(window=3, name="t")
    pipe.submit(lambda: done.append(1))
    pipe.submit(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    pipe.submit(lambda: done.append(2))
    pipe.abort()  # must not raise
    assert sorted(done) == [1, 2]


def test_executor_window_floor_is_one(pl):
    pipe = pl.BoundedExecutor(window=0, name="t")
    assert pipe.window == 1
    pipe.submit(lambda: 7)
    assert pipe.drain() == [7]


# ---------------------------------------------------------- TieredChunkCache


def _cache_trace(mod, directory):
    c = mod.TieredChunkCache(directory=directory, mem_budget=3000, mem_limit=1000)
    out = []
    for i in range(12):
        c.put(f"1,{i:x}", bytes([i]) * (400 + 300 * (i % 4)))
        out.append([c.get(f"1,{k:x}") is not None for k in range(i + 1)])
    out.append(c.get("9,ff"))
    return out, c.stats()


@pytest.mark.parametrize("disk", [False, True], ids=["memory", "memory+disk"])
def test_tiered_chunk_cache_equal(tmp_path, disk):
    j = _cache_trace(j_cache, str(tmp_path / "j") if disk else None)
    p = _cache_trace(p_cache, str(tmp_path / "p") if disk else None)
    assert j == p


# --------------------------------------------------------------- hedged_call


@pytest.fixture
def hedges(monkeypatch):
    for mod in (j_hedge, p_hedge):
        mod.STATS.reset()
    for k in ("SWEED_HEDGE", "SWEED_HEDGE_BUDGET", "SWEED_HEDGE_DELAY_MS"):
        monkeypatch.delenv(k, raising=False)
    yield {"jax": j_hedge, "port": p_hedge}
    for mod in (j_hedge, p_hedge):
        mod.STATS.reset()


def _hedge_trace(h):
    out = []
    release = threading.Event()

    def slow():
        release.wait(5)
        return b"slow"

    def down():
        raise ConnectionError("replica down")

    out.append(h.hedged_call(lambda: b"data", lambda: b"hedge", 0.2))
    out.append(h.hedged_call(slow, lambda: b"fast-replica", 0.02))
    release.set()
    out.append(h.hedged_call(down, lambda: b"ok", 5.0))
    out.append(h.hedged_call(lambda: 41, None, 0.01))
    try:
        h.hedged_call(down, down, 0.01)
    except ConnectionError as e:
        out.append(str(e))
    out.append([h.pick_delay_s(x) for x in (None, 0.0, 0.00001, 0.120)])
    return out, h.STATS.snapshot()


def test_hedged_call_equal(hedges):
    assert _hedge_trace(hedges["jax"]) == _hedge_trace(hedges["port"])


def test_hedge_budget_gate_equal(hedges, monkeypatch):
    monkeypatch.setenv("SWEED_HEDGE_BUDGET", "0.05")

    def slow():
        time.sleep(0.03)
        return b"p"

    snaps = []
    for h in hedges.values():
        for _ in range(8):
            h.hedged_call(slow, lambda: b"h", delay_s=0.001)
        snaps.append(h.STATS.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["fired"] == 4 and snaps[1]["skipped_budget"] == 4


def test_ahedged_call_equal(hedges):
    import asyncio

    async def run(h):
        async def fast():
            return b"p"

        async def slow():
            await asyncio.sleep(5)
            return b"slow"

        async def fail():
            raise ConnectionError("boom")

        async def ok():
            return b"ok"
        return [await h.ahedged_call(fast, ok, 0.2), await h.ahedged_call(slow, ok, 0.02),
                await h.ahedged_call(fail, ok, 5.0)]
    assert asyncio.run(run(hedges["jax"])) == asyncio.run(run(hedges["port"]))
