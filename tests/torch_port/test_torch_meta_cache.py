"""The port's mount meta cache (``seaweedfs_tpu_torch/mount/meta_cache.py``)
against either package's filer, with no poller thread: ``poll_once()``
applies the feed's events when the test says so.

A writer creates, renames (within a directory and across two), unlinks and
sets and removes xattrs; then the reader lists the tree (the lazy fill) and
only then polls the events, all of them older than its listings. The JAX
package's cache replays such events over the listing, so an entry the
writer removed comes back until a later batch removes it again. The port's
drops every event side at or before its directory's listing: after every
poll, with feed pages of one event or of a thousand, the reader's listings,
its lookups (None for what was renamed away or unlinked) and its xattrs are
the filer's own. An event after the listing still shows. A poll started
between a listing's mark and the listing, while the writer creates and then
renames a file, never brings the renamed-away name back.

The tolerance is exact equality of (path, is_directory, size, mode, xattrs,
chunk fids).
"""

from __future__ import annotations

import threading

import pytest

from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.mount import meta_cache as meta_cache_mod
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.mount import WFS, MetaCache

from gateway_pair import Stack


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meta_cache")
    out = {"port": Stack("port", tmp), "jax": Stack("jax", tmp)}
    yield out
    for s in out.values():
        s.stop()


def _write(w: WFS, root: str) -> dict:
    """The writer's changes under ``root``; returns the paths they removed."""
    w.mkdir(f"{root}/sub")
    w.mkdir(f"{root}/away")
    for i in range(5):
        w.write_file(f"{root}/sub/f{i}.bin", bytes([i]) * (1000 + 700 * i))
    w.write_file(f"{root}/top.txt", b"top")
    w.rename(f"{root}/sub/f1.bin", f"{root}/sub/f1-renamed.bin")  # within a dir
    w.rename(f"{root}/sub/f2.bin", f"{root}/moved.bin")  # across two listed dirs
    w.rename(f"{root}/sub/f3.bin", f"{root}/away/f3.bin")  # into a dir not yet listed
    w.unlink(f"{root}/sub/f4.bin")
    w.setxattr(f"{root}/moved.bin", "user.color", b"indigo")
    w.setxattr(f"{root}/moved.bin", "user.gone", b"x")
    w.removexattr(f"{root}/moved.bin", "user.gone")
    w.setxattr(f"{root}/sub/f0.bin", "user.kept", bytes(range(32)))
    return {f"{root}/sub/{n}.bin" for n in ("f1", "f2", "f3", "f4")}


def _row(e: Entry) -> tuple:
    return (e.full_path, e.is_directory, e.file_size(), e.mode,
            sorted((e.extended or {}).items()), [c.file_id for c in e.chunks])


def _filer_view(client: FilerClient, dirs: list) -> dict:
    return {d: [_row(Entry.from_dict(x)) for x in client.list(d)] for d in dirs}


def _cache_view(cache: MetaCache, dirs: list) -> dict:
    return {d: [_row(e) for e in cache.list_dir(d)] for d in dirs}


def _poll_all(cache: MetaCache, check) -> int:
    polled = 0
    while n := cache.poll_once():
        polled += n
        check()
    return polled


@pytest.mark.parametrize("batch", [1, 1000])
@pytest.mark.parametrize("filer_kind", ["jax", "port"])
def test_stale_events_leave_a_fresher_listing_alone(stacks, filer_kind, batch, monkeypatch):
    monkeypatch.setattr(meta_cache_mod, "_PAGE", batch)
    url = stacks[filer_kind].url
    root = f"/stale-{filer_kind}-{batch}"
    w = WFS(url, chunk_size=64 * 1024, use_meta_cache=False)
    cache = MetaCache(url)  # not started: no poller thread
    client = FilerClient(url)
    try:
        removed = _write(w, root)
        listed = [root, f"{root}/sub"]
        want = _filer_view(client, listed)
        assert [r[0] for r in want[f"{root}/sub"]] == \
            [f"{root}/sub/f0.bin", f"{root}/sub/f1-renamed.bin"]
        assert _cache_view(cache, listed) == want  # the lazy fill

        def unchanged():
            assert _cache_view(cache, listed) == want
            for p in removed:
                assert cache.lookup(p) is None, p

        assert _poll_all(cache, unchanged) > 0
        assert cache.stale_dropped > 0
        moved = cache.lookup(f"{root}/moved.bin")
        assert moved is not None and moved.extended == \
            Entry.from_dict(client.get_entry(f"{root}/moved.bin")).extended
        assert sorted(moved.extended) == ["xattr-user.color"]
        # the rename's far side was applied: its directory had no listing
        assert cache._db.execute("SELECT 1 FROM entries WHERE path = ?",
                                 (f"{root}/away/f3.bin",)).fetchone()
        assert _cache_view(cache, [f"{root}/away"]) == _filer_view(client, [f"{root}/away"])

        # events after the listing still change it
        dropped = cache.stale_dropped
        w.write_file(f"{root}/sub/late.bin", b"late")
        w.rename(f"{root}/sub/f0.bin", f"{root}/f0-up.bin")
        w.setxattr(f"{root}/top.txt", "user.late", b"1")
        assert _poll_all(cache, lambda: None) > 0
        assert cache.stale_dropped == dropped
        assert _cache_view(cache, listed) == _filer_view(client, listed)
        assert cache.lookup(f"{root}/sub/late.bin") is not None
        assert cache.lookup(f"{root}/sub/f0.bin") is None
    finally:
        cache.stop()
        w.close()


@pytest.mark.parametrize("filer_kind", ["jax", "port"])
def test_a_listing_after_the_poll_is_not_undone(stacks, filer_kind):
    """Polled first, listed after: the events were applied before the
    listing's mark, so nothing is dropped and the view is the filer's."""
    url = stacks[filer_kind].url
    root = f"/polled-first-{filer_kind}"
    w = WFS(url, chunk_size=64 * 1024, use_meta_cache=False)
    cache = MetaCache(url)
    client = FilerClient(url)
    try:
        _write(w, root)
        while cache.poll_once():
            pass
        listed = [root, f"{root}/sub", f"{root}/away"]
        assert _cache_view(cache, listed) == _filer_view(client, listed)
        assert cache.stale_dropped == 0
        assert cache.poll_once() == 0
    finally:
        cache.stop()
        w.close()


@pytest.mark.parametrize("filer_kind", ["jax", "port"])
def test_listing_and_mark_read_every_page(stacks, filer_kind, monkeypatch):
    """With pages of two, a directory's listing takes every page (the
    listing replaces what events put there, so a first page alone would
    lose the rest) and its mark is the feed's last event, not the first
    page's: the events before it are all dropped."""
    monkeypatch.setattr(meta_cache_mod, "_PAGE", 2)
    url = stacks[filer_kind].url
    root = f"/paged-{filer_kind}"
    w = WFS(url, chunk_size=64 * 1024, use_meta_cache=False)
    cache = MetaCache(url)
    client = FilerClient(url)
    try:
        _write(w, root)
        listed = [root, f"{root}/sub"]
        want = {d: [_row(Entry.from_dict(x)) for x in client.list(d, limit=1000)]
                for d in listed}
        assert len(want[root]) == 4
        assert _cache_view(cache, listed) == want

        def unchanged():
            assert _cache_view(cache, listed) == want

        assert _poll_all(cache, unchanged) > 0
        assert cache.stale_dropped > 0
    finally:
        cache.stop()
        w.close()


@pytest.mark.parametrize("filer_kind", ["jax", "port"])
def test_a_poll_during_a_listing_brings_nothing_back(stacks, filer_kind, monkeypatch):
    """Between the listing's mark and the listing itself, the writer creates
    ``f.bin``, a poll starts on another thread, and the writer renames the
    file to ``g.bin``. A poll that read the feed there would hold the create
    but not the rename, and apply it over the listing: ``f.bin`` would come
    back. The poll waits for the listing, then applies both."""
    url = stacks[filer_kind].url
    root = f"/poll-in-listing-{filer_kind}"
    w = WFS(url, chunk_size=64 * 1024, use_meta_cache=False)
    cache = MetaCache(url)
    client = FilerClient(url)
    w.mkdir(root)
    poller = threading.Thread(target=cache.poll_once)
    polled, read = threading.Event(), cache.client.meta_events

    def meta_events(**kw):
        r = read(**kw)
        if threading.current_thread() is poller:
            polled.set()
        return r

    def list_all(dir_path, real=cache._list_all):
        if not poller.is_alive() and not polled.is_set():
            w.write_file(f"{root}/f.bin", b"f" * 1000)
            poller.start()
            polled.wait(timeout=1.0)  # set if the poll read the feed here
            w.rename(f"{root}/f.bin", f"{root}/g.bin")
        return real(dir_path)

    monkeypatch.setattr(cache.client, "meta_events", meta_events)
    monkeypatch.setattr(cache, "_list_all", list_all)
    try:
        got = _cache_view(cache, [root])  # the lazy fill
        want = _filer_view(client, [root])
        assert [r[0] for r in want[root]] == [f"{root}/g.bin"]
        assert got == want
        poller.join(timeout=10)
        assert not poller.is_alive() and polled.is_set()
        assert _cache_view(cache, [root]) == want
        assert cache.lookup(f"{root}/f.bin") is None
        assert cache.poll_once() == 0
        assert _cache_view(cache, [root]) == want
    finally:
        cache.stop()
        w.close()
