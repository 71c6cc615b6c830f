"""The port's degraded EC read against the JAX package's ``Store``.

The port departs from the JAX package in timing and fetch order only:

- a remote shard reader that reports that no server holds the shard
  (``NoShardHolderError``) is asked once, with no retry and no backoff, and
  the read goes straight to reconstruction;
- ``recover_interval`` reads the local siblings first and fetches the
  remote ones it still needs concurrently, starting another only when one
  fails, each fetch in a copy of the caller's context;
- the volume server keeps the master's ``/dir/lookup_ec`` answer for a
  short while and drops it when a holder it named fails.

Every needle read here must give the bytes the JAX package's ``Store`` gives
on the same files, made from a seed with numpy.
"""

import contextlib
import os
import shutil
import socket
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.server import volume_server as pvs
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage import store as pstore
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.store import NoShardHolderError
from seaweedfs_tpu_torch.storage.store import Store as PStore
from seaweedfs_tpu_torch.util import deadline
from seaweedfs_tpu_torch.util import retry as pretry

VID, COOKIE, LOST = 4, 0x77, 1
EC_FILES = [shard_ext(i) for i in range(14)] + [".ecx", ".vif"]


def _blobs(seed, n=30, lo=100_000, hi=300_000):
    rng = np.random.default_rng(seed)
    return {i: rng.bytes(int(rng.integers(lo, hi))) for i in range(1, n + 1)}


def _read(store, mod, nid):
    n = mod(id=nid)
    store.read_volume_needle(VID, n)
    return n.cookie, n.data


@pytest.fixture
def sealed(tmp_path):
    """(directory of the 14 shards, .ecx and .vif of volume 4, blobs): the
    port's Store seals a volume of seeded needles; its .dat stays aside."""
    src = tmp_path / "src"
    blobs = _blobs(17)
    s = PStore([str(src)], ec_backend="cpu")
    try:
        s.add_volume(VID)
        for nid, data in blobs.items():
            s.write_volume_needle(VID, PNeedle(cookie=COOKIE, id=nid, data=data))
        s.find_volume(VID).sync()
        s.ec_encode_volume(VID)
    finally:
        s.close()
    ec = tmp_path / "ec"
    ec.mkdir()
    for ext in EC_FILES:
        shutil.copy(src / f"{VID}{ext}", ec / f"{VID}{ext}")
    return ec, blobs


def _mount(tmp_path, ec, name, shards, cls, **kw):
    """A Store over a copy of ``ec`` holding only ``shards``."""
    d = tmp_path / name
    d.mkdir()
    for ext in EC_FILES:
        if not ext.startswith(".ec") or ext == ".ecx" or int(ext[3:]) in shards:
            shutil.copy(ec / f"{VID}{ext}", d / f"{VID}{ext}")
    backend = "cpu" if cls is PStore else "numpy"
    return cls([str(d)], ec_backend=backend, **kw)


def _shard_bytes(ec):
    out = {}
    for sid in range(14):
        with open(ec / f"{VID}{shard_ext(sid)}", "rb") as f:
            out[sid] = f.read()
    return out


def _count_reconstructs(store):
    codec = store.ec_codec
    calls = [0]
    real = codec.reconstruct

    def counting(shards, data_only=False):
        calls[0] += 1
        return real(shards, data_only=data_only)

    codec.reconstruct = counting
    return calls


class _Reader:
    """A remote shard reader over the shards' bytes: ``no_holder`` shards
    raise NoShardHolderError (``none`` makes them answer None, the JAX
    package's form), ``failing`` shards answer None; calls are counted, with
    the trace span and deadline each one saw, and ``events`` logs each
    call's start and answer in order. With a ``barrier``, the first
    ``barrier.parties`` calls wait at it before they answer, so they pass
    only if that many are in flight at once."""

    def __init__(self, shard_bytes, no_holder=(), failing=(), none=False, barrier=None):
        self.bytes, self.no_holder, self.failing = shard_bytes, set(no_holder), set(failing)
        self.none, self.barrier = none, barrier
        self.calls, self.seen, self.events = [], [], []
        self.lock = threading.Lock()

    def __call__(self, vid, sid, offset, size):
        with self.lock:
            self.calls.append(sid)
            self.seen.append((trace.current_span(), deadline.current()))
            self.events.append(("start", sid))
            held = self.barrier is not None and len(self.calls) <= self.barrier.parties
        if sid in self.no_holder:
            if self.none:
                return None
            raise NoShardHolderError(f"no server holds shard {vid}.{sid}")
        if held:
            self.barrier.wait()
        got = None if sid in self.failing else self.bytes[sid][offset:offset + size]
        with self.lock:
            self.events.append(("answer", sid, got is not None))
        return got


@contextlib.contextmanager
def _read_path_sleeps(monkeypatch):
    """Within the block, every ``time.sleep`` of the calling thread and of
    the EC sibling fetches, as (thread name, seconds); each still sleeps."""
    caller, real, slept = threading.current_thread(), time.sleep, []

    def sleep(s):
        t = threading.current_thread()
        if t is caller or t.name.startswith("ec-sibling"):
            slept.append((t.name, s))
        real(s)

    with monkeypatch.context() as m:
        m.setattr(time, "sleep", sleep)
        yield slept


def test_no_holder_is_asked_once_with_no_backoff(tmp_path, sealed, monkeypatch):
    """Shard 1 is lost and no server holds it: the port's reader is asked
    once per lost interval and nothing sleeps, where the JAX package asks
    three times; both reconstruct each interval once, to the same bytes."""
    ec, blobs = sealed
    others = set(range(14)) - {LOST}
    ps = _mount(tmp_path, ec, "port", others, PStore, remote_fetch_backoff_s=10.0)
    js = _mount(tmp_path, ec, "jax", others, JStore, remote_fetch_backoff_s=0.001)
    sleeps = []
    monkeypatch.setattr(pretry, "time", types.SimpleNamespace(
        monotonic=time.monotonic, sleep=lambda s: sleeps.append(s)))
    try:
        shard_bytes = _shard_bytes(ec)
        ps.remote_shard_reader = preader = _Reader(shard_bytes, no_holder={LOST})
        js.remote_shard_reader = jreader = _Reader(shard_bytes, no_holder={LOST}, none=True)
        precon, jrecon = _count_reconstructs(ps), _count_reconstructs(js)
        with _read_path_sleeps(monkeypatch) as slept:
            t0 = time.perf_counter()
            got = {nid: _read(ps, PNeedle, nid) for nid in blobs}
            elapsed = time.perf_counter() - t0
        for nid, want in blobs.items():
            assert got[nid] == _read(js, JNeedle, nid) == (COOKIE, want)
        assert precon[0] == jrecon[0] > 0
        assert preader.calls == [LOST] * precon[0]
        assert jreader.calls == [LOST] * (3 * jrecon[0])
        assert sleeps == []
        # a backoff of up to 10 s per lost interval would be a sleep on the
        # reading thread or a sibling's, or, taken some other way (an event
        # or a future waited on), a pause of that size: far past what a
        # loaded host adds to reads that make none
        assert slept == []
        assert elapsed < 10.0 * precon[0], (elapsed, precon[0])
    finally:
        ps.close()
        js.close()


def test_siblings_are_fetched_concurrently(tmp_path, sealed):
    """Three local shards: seven remote siblings are needed, one of them
    failing. ``recover_interval`` fetches the seven at once (they meet at a
    barrier of seven, which a serial fetch would break) and replaces the
    failed one by the next holder only after it failed, inside the caller's
    trace (each fetch under a ``store.fetch_sibling`` span of the caller's)
    and deadline; its bytes are the lost shard's."""
    ec, _ = sealed
    local = {0, 2, 3}
    ps = _mount(tmp_path, ec, "port", local, PStore)
    try:
        shard_bytes = _shard_bytes(ec)
        reader = _Reader(shard_bytes, failing={5}, barrier=threading.Barrier(7, timeout=10))
        ev = ps.find_ec_volume(VID)
        offset, size = 4096, 300_000
        with trace.start_span("degraded-read", service="test") as span, \
                deadline.scope(deadline.after(30.0)) as dl:
            got = pstore.recover_interval(ev, ps.ec_codec, LOST, offset, size, reader)
        assert got == shard_bytes[LOST][offset:offset + size]
        # the first seven remote candidates at once, then shard 11 for shard 5
        assert sorted(reader.calls) == [4, 5, 6, 7, 8, 9, 10, 11]
        assert sorted(reader.calls[:7]) == [4, 5, 6, 7, 8, 9, 10]
        assert not reader.barrier.broken
        assert reader.events.index(("start", 11)) > reader.events.index(("answer", 5, False))
        assert [(s.name, s.trace_id, s.parent_id, d) for s, d in reader.seen] == [
            ("store.fetch_sibling", span.trace_id, span.span_id, dl)] * len(reader.calls)
    finally:
        ps.close()


def test_a_failing_fetch_is_retried_with_backoff(tmp_path, sealed, monkeypatch):
    """A remote fetch that keeps failing is tried ``remote_fetch_attempts``
    times, with a backoff of at most the policy's before each retry, and
    then left to reconstruction."""
    ec, _ = sealed
    ps = _mount(tmp_path, ec, "port", set(range(14)) - {LOST}, PStore,
                remote_fetch_backoff_s=0.01)
    sleeps = []
    monkeypatch.setattr(pretry, "time", types.SimpleNamespace(
        monotonic=time.monotonic, sleep=sleeps.append))
    try:
        ps.remote_shard_reader = reader = _Reader(_shard_bytes(ec), failing={LOST})
        assert ps._remote_shard_read(VID, LOST, 0, 1000) is None
        assert reader.calls == [LOST] * ps.remote_fetch_attempts
        assert len(sleeps) == ps.remote_fetch_attempts - 1 > 0
        assert all(0 <= s <= 0.01 * 2 ** k for k, s in enumerate(sleeps)), sleeps
    finally:
        ps.close()


def test_concurrent_siblings_keep_the_reference_bytes(tmp_path, sealed):
    """Both Stores with the same four local shards read every needle through
    the same kind of reader (shard 1 held by no server, shard 5 failing):
    the port's bytes and reconstruct counts are the JAX package's."""
    ec, blobs = sealed
    local = {0, 2, 3, 4}
    ps = _mount(tmp_path, ec, "port", local, PStore, remote_fetch_backoff_s=0.001)
    js = _mount(tmp_path, ec, "jax", local, JStore, remote_fetch_backoff_s=0.001)
    try:
        shard_bytes = _shard_bytes(ec)
        ps.remote_shard_reader = _Reader(shard_bytes, no_holder={LOST}, failing={5})
        js.remote_shard_reader = _Reader(shard_bytes, no_holder={LOST}, failing={5}, none=True)
        precon, jrecon = _count_reconstructs(ps), _count_reconstructs(js)
        for nid, want in blobs.items():
            assert _read(ps, PNeedle, nid) == _read(js, JNeedle, nid) == (COOKIE, want)
        # every interval on a lost or remote data shard is rebuilt
        assert precon[0] == jrecon[0] > 0
    finally:
        ps.close()
        js.close()


# -- two port volume servers beside a port master -----------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout=20.0):
    end = time.time() + timeout
    while time.time() < end:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _holders(master, sid):
    return set(master.master.lookup_ec_volume(VID)["shard_id_locations"].get(sid, []))


def _on_lost_shard(ec, blobs):
    """Needles with a byte on data shard 1 (the .dat is striped in 1 MiB
    blocks over the 10 data shards)."""
    from seaweedfs_tpu_torch.storage import idx
    from seaweedfs_tpu_torch.storage.needle import get_actual_size

    with open(ec.parent / "src" / f"{VID}.idx", "rb") as f:
        entries = list(idx.iter_index_file(f))
    block = 1 << 20
    out = []
    for key, off, size in entries:
        end = off + get_actual_size(size, 3)
        if any(b % 10 == LOST for b in range(off // block, (end - 1) // block + 1)):
            out.append(key)
    assert len(out) >= 4
    return out


def test_lookup_is_cached_and_a_moved_shard_is_followed(tmp_path, sealed, monkeypatch):
    """Server A holds 13 shards, B shard 1. N degraded reads on A within the
    expiry cost one ``/dir/lookup_ec`` and no reconstruction. B stops and
    shard 1 is mounted on C: the next read on A follows it, with one lookup
    more. Every needle's bytes are the JAX package's."""
    monkeypatch.setenv("SWEED_TURBO", "0")
    ec, blobs = sealed
    lookups = []
    real_http_json = pvs.http_json

    def counting(method, url, *a, **kw):
        if "/dir/lookup_ec" in url:
            lookups.append(url)
        return real_http_json(method, url, *a, **kw)

    monkeypatch.setattr(pvs, "http_json", counting)
    full = _mount(tmp_path, ec, "jax", set(range(14)), JStore)
    want = {nid: _read(full, JNeedle, nid) for nid in blobs}
    full.close()

    def server_dir(name, shards):
        d = tmp_path / name
        d.mkdir()
        for sid in shards:
            shutil.copy(ec / f"{VID}{shard_ext(sid)}", d / f"{VID}{shard_ext(sid)}")
        if shards:
            for ext in (".ecx", ".vif"):
                shutil.copy(ec / f"{VID}{ext}", d / f"{VID}{ext}")
        return d

    master = PMasterServer(port=_free_port(), node_timeout=60).start()
    dirs = {"a": server_dir("a", set(range(14)) - {LOST}), "b": server_dir("b", {LOST}),
            "c": server_dir("c", set())}
    servers = {name: PVolumeServer([str(d)], port=_free_port(), master_url=master.url,
                                   pulse_seconds=0.2, ec_backend="cpu")
               for name, d in dirs.items()}
    a, b, c = servers["a"], servers["b"], servers["c"]
    stopped = set()
    try:
        for vs in servers.values():
            vs.start()
        assert _wait(lambda: len(master.master.lookup_ec_volume(VID)["shard_id_locations"])
                     == 14)
        recon = _count_reconstructs(a.store)
        keys = _on_lost_shard(ec, blobs)

        def get(vs, key):
            fid = str(FileId(VID, key, COOKIE))
            status, data = http_bytes("GET", f"http://127.0.0.1:{vs.port}/{fid}")
            assert status == 200
            return data

        for key in keys:
            assert (COOKIE, get(a, key)) == want[key]
        assert len(lookups) == 1 and a.ec_lookups == 1
        assert recon[0] == 0

        b.stop()
        stopped.add("b")
        for ext in (shard_ext(LOST), ".ecx", ".vif"):
            shutil.copy(ec / f"{VID}{ext}", dirs["c"] / f"{VID}{ext}")
        assert http_json("POST", f"http://127.0.0.1:{c.port}/admin/ec/mount?volume={VID}"
                         )["shards"] == [LOST]
        assert _wait(lambda: f"127.0.0.1:{c.port}" in _holders(master, LOST))
        assert (COOKIE, get(a, keys[0])) == want[keys[0]]
        assert len(lookups) == 2
        assert recon[0] == 0
        for key in keys[1:]:
            assert (COOKIE, get(a, key)) == want[key]
        assert len(lookups) == 2 and recon[0] == 0
    finally:
        for name, vs in servers.items():
            if name not in stopped:
                vs.stop()
        master.stop()


def test_a_degraded_reads_tree_holds_the_store_spans(tmp_path, sealed):
    """A needle read with shard 1 lost and six shards remote: the read's
    trace holds a ``store.ec_read`` per interval read, a
    ``store.fetch_sibling`` per remote shard fetch and a
    ``store.reconstruct`` per interval rebuilt, each tagged with its bytes,
    as an operator's ``/debug/traces?trace=<id>`` tree shows them."""
    ec, blobs = sealed
    local = {0, 2, 3, 4}
    ps = _mount(tmp_path, ec, "port", local, PStore, remote_fetch_backoff_s=0.001)
    try:
        ps.remote_shard_reader = _Reader(_shard_bytes(ec), no_holder={LOST})
        precon = _count_reconstructs(ps)
        trace.RING.clear()
        with trace.start_span("GET /", service="volume") as root:
            got = {nid: _read(ps, PNeedle, nid) for nid in blobs}
        assert got == {nid: (COOKIE, want) for nid, want in blobs.items()}
        spans = trace.RING.for_trace(root.trace_id)
    finally:
        ps.close()
    (tree,) = trace.assemble_tree(spans)
    reads = [c for c in tree["children"] if c["name"] == "store.ec_read"]
    assert len(reads) == len(tree["children"]) > len(blobs)
    assert sum(r["tags"]["bytes"] for r in reads) >= sum(len(b) for b in blobs.values())
    below = [c for r in reads for c in r["children"]]
    recon = [c for c in below if c["name"] == "store.reconstruct"]
    assert len(recon) == precon[0] > 0
    assert all(r["tags"]["shard"] == LOST and r["tags"]["bytes"] > 0 for r in recon)
    fetches = [c for c in below if c["name"] == "store.fetch_sibling"]
    # the lost shard asked once per rebuilt interval, six remote siblings each
    assert sorted({f["tags"]["shard"] for f in fetches}) == [1, 5, 6, 7, 8, 9, 10]
    assert all((f["tags"]["bytes"] > 0) == (f["tags"]["shard"] != LOST) for f in fetches)
    assert sum(f["tags"]["shard"] == LOST for f in fetches) == len(recon)
