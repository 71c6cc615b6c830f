"""Ranged chunk reads through the port's filer, held against the JAX
package's filer over one port cluster.

One port master and three port volume servers (``ec_backend="cpu"``, the
native engine on their public ports) serve the JAX package's filer and the
port's side by side, both at 6 MiB chunks, ``read_window`` 4 and the
default chunk cache (a 4 MiB memory tier, no disk tier). Each writes the
same objects: a plain 15 MiB one (chunks of 6, 6 and 3 MiB), a cipher'd
13 MiB one and a 13 MiB text one whose chunks the filer gzips.

Seeded ranges (the first byte, the last, across the chunk boundary, inside
one chunk, a suffix, the tail chunk, a whole chunk) are read through the
port's ``_stream_range``, ``_read_range`` and its native asyncio GET, and
each equals the JAX filer's answer to the same request. The port asks a
volume server for a view's bytes only when the view is part of a plain
chunk too large to cache: the bytes the volume servers send are counted
(at the transport), at most the range plus one cacheable chunk for the
plain and gzip'd objects, a whole chunk a view for the cipher'd one.
Ranged pieces stay out of the cache. A 3-replica object shows the hedge
leg, the fall-through replica and ``operation.download``'s failover
sending the same ``Range``, in the threaded and the native fetch.

Then the port shell's ``ec.encode`` seals the volumes, shards {0, 3, 10,
13} are deleted wherever they lie, and the same ranges read equal through
both filers again.
"""

import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.filer.filechunks import view_from_chunks
from seaweedfs_tpu_torch.server import aio_transport, http_util
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.util import hedge

MiB = 1 << 20
CHUNK = 6 * MiB
LOST = (0, 3, 10, 13)
COLLECTION = "rr"


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _objects():
    rng = np.random.default_rng(18)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    rows = [b",".join([str(i).encode(), words[i % 6], str(int(v)).encode()])
            for i, v in enumerate(rng.integers(0, 10**6, 700_000))]
    text = b"\n".join(rows)[: 13 * MiB]
    return {
        "/r/plain.bin": (rng.bytes(15 * MiB), ""),
        "/r/cipher.bin": (rng.bytes(13 * MiB), "&cipher=true"),
        "/r/text.csv": (text, ""),
    }


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranged")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volumes = [VolumeServer([str(tmp / f"srv{i}")], port=free_port(), master_url=master.url,
                            max_volume_count=30, pulse_seconds=0.5, ec_backend="cpu").start()
               for i in range(3)]
    kw = dict(master_url=master.url, chunk_size=CHUNK, read_window=4, write_window=4)
    filers = {"jax": JFilerServer(port=free_port(), **kw).start(),
              "port": PFilerServer(port=free_port(), query_backend="cpu", **kw).start()}
    time.sleep(0.6)
    objects = _objects()
    for f in filers.values():
        for path, (data, q) in objects.items():
            st, body = http_bytes("POST", f"http://{f.url}{path}?collection={COLLECTION}{q}", data)
            assert st == 201, body
    yield master, volumes, filers, objects
    threading.Thread(target=filers["jax"].stop, daemon=True).start()
    filers["port"].stop()
    for v in volumes:
        v.stop()
    master.stop()


def _ranges(size):
    rng = np.random.default_rng(size)
    a = int(rng.integers(0, CHUNK - MiB))
    return [(0, 1), (size - 1, 1), (CHUNK - 1000, 2000), (a, int(rng.integers(1, MiB))),
            (size - 5000, 5000), (2 * CHUNK + 17, 4096), (CHUNK, CHUNK),
            (int(rng.integers(CHUNK, 2 * CHUNK - 70_000)), 65_536)]


def _http_range(filer, path, offset, size):
    req = urllib.request.Request(f"http://{filer.url}{path}")
    req.add_header("Range", f"bytes={offset}-{offset + size - 1}")
    with urllib.request.urlopen(req) as resp:
        return resp.status, resp.read()


class Tally:
    """What the volume servers sent the port's filer: each chunk GET's url,
    Range header and body length, seen at both transports (and at
    ``operation``'s); ``fail`` makes the first N chunk GETs answer 500, and
    ``slow`` delays the first one."""

    def __init__(self, monkeypatch, volume_ports, fail=0, slow=0.0):
        self.calls, self.fail, self.slow = [], fail, slow
        self.lock = threading.Lock()
        self.ports = {f":{p}/" for p in volume_ports}
        real_sync, real_async = http_util.http_bytes, aio_transport.request

        def sync(method, url, body=None, timeout=30.0, headers=None, idempotent=False):
            failed = self._note(method, url, headers)
            if failed:
                return 500, b""
            status, data = real_sync(method, url, body, timeout, headers, idempotent)
            self._size(url, data)
            return status, data

        async def aio(method, url, body=None, headers=None, timeout=30.0):
            if self._note(method, url, headers):
                return 500, b"", {}
            status, data, hdrs = await real_async(method, url, body, headers, timeout)
            self._size(url, data)
            return status, data, hdrs

        monkeypatch.setattr(http_util, "http_bytes", sync)
        monkeypatch.setattr(operation, "http_bytes", sync)
        monkeypatch.setattr(aio_transport, "request", aio)

    def _chunk(self, method, url):
        return method == "GET" and any(p in url for p in self.ports)

    def _note(self, method, url, headers):
        if not self._chunk(method, url):
            return False
        with self.lock:
            self.calls.append([url, (headers or {}).get("Range"), 0])
            first = len(self.calls) == 1
            if self.fail > 0:
                self.fail -= 1
                return True
        if first and self.slow:
            time.sleep(self.slow)  # a slow primary: the hedge leg fires
        return False

    def _size(self, url, data):
        if any(p in url for p in self.ports):
            with self.lock:
                for call in reversed(self.calls):
                    if call[0] == url and call[2] == 0:
                        call[2] = len(data)
                        break

    def sent(self):
        return sum(c[2] for c in self.calls)


def _entry(filer, path):
    return filer.filer.find_entry(path)


def _stream(filer, path, offset, size):
    return b"".join(filer._stream_range(_entry(filer, path), offset, size))


@pytest.mark.parametrize("path", ["/r/plain.bin", "/r/cipher.bin", "/r/text.csv"])
def test_ranges_equal_the_jax_filer_and_move_only_their_bytes(stack, monkeypatch, path):
    master, volumes, filers, objects = stack
    data = objects[path][0]
    port = filers["port"]
    port.chunk_cache.mem._lru.clear()
    port.chunk_cache.mem._bytes = 0
    http_bytes("GET", f"http://{port.url}{path}")  # the vid map learns the volumes
    for offset, size in _ranges(len(data)):
        want = data[offset:offset + size]
        assert _http_range(filers["jax"], path, offset, size) == (206, want)
        entry = _entry(port, path)
        views = view_from_chunks(list(entry.chunks), offset, size)
        ranged = [port._chunk_range(v) for v in views]
        for name, read in (("stream", lambda: _stream(port, path, offset, size)),
                           ("read_range", lambda: port._read_range(entry, offset, size)),
                           ("native", lambda: _http_range(port, path, offset, size)[1])):
            port.chunk_cache.mem._lru.clear()
            port.chunk_cache.mem._bytes = 0
            tally = Tally(monkeypatch, [v.port for v in volumes])
            assert read() == want, (name, offset, size)
            if name == "native":
                assert tally.calls, "the native GET fetched through the loop's transport"
            whole = sum(v.chunk_size for v, r in zip(views, ranged) if r is None)
            if path == "/r/cipher.bin":
                assert not any(ranged)
                assert tally.sent() >= whole, (name, offset, size)
            else:
                part = sum(v.size for v, r in zip(views, ranged) if r is not None)
                assert tally.sent() == part + whole, (name, offset, size, tally.calls)
                assert whole <= 4 * MiB or all(r is None for r in ranged)
                assert tally.sent() <= size + 4 * MiB
            for (url, rng, _), v, r in zip(tally.calls, views, ranged):
                if r is not None:
                    assert rng == f"bytes={r[0]}-{r[0] + r[1] - 1}"
            monkeypatch.undo()
    # a range over the end of chunk 1 and the start of the 1-3 MiB tail:
    # the cache keeps the whole tail chunk, and nothing of chunk 1
    port.chunk_cache.mem._lru.clear()
    port.chunk_cache.mem._bytes = 0
    assert _stream(port, path, 2 * CHUNK - 100, 200) == data[2 * CHUNK - 100:2 * CHUNK + 100]
    entry = _entry(port, path)
    tail = max(entry.chunks, key=lambda c: c.offset)
    cached = dict(port.chunk_cache.mem._lru)
    assert list(cached) == [tail.file_id]
    assert len(cached[tail.file_id]) >= tail.size


def test_small_views_and_cached_chunks_fetch_whole(stack):
    """A chunk the cache keeps is fetched whole and cached, as before."""
    _, _, filers, objects = stack
    port = filers["port"]
    entry = _entry(port, "/r/plain.bin")
    tail = [v for v in view_from_chunks(list(entry.chunks), 2 * CHUNK + 5, 100)]
    assert len(tail) == 1 and tail[0].chunk_size == 3 * MiB
    assert port._chunk_range(tail[0]) is None
    head = view_from_chunks(list(entry.chunks), 5, 100)[0]
    assert port._chunk_range(head) == (5, 100)
    full = view_from_chunks(list(entry.chunks), 0, CHUNK)[0]
    assert full.is_full_chunk and port._chunk_range(full) is None
    data = objects["/r/plain.bin"][0]
    assert port._read_range(entry, 2 * CHUNK + 5, 100) == data[2 * CHUNK + 5:2 * CHUNK + 105]
    assert port.chunk_cache.get(tail[0].file_id) == data[2 * CHUNK:]


@pytest.fixture(scope="module")
def replicated(stack):
    """A 13 MiB object on volumes with three replicas (``002``)."""
    master, volumes, filers, objects = stack
    rng = np.random.default_rng(7)
    data = rng.bytes(13 * MiB)
    port = filers["port"]
    st, body = http_bytes("POST", f"http://{port.url}/r/rep.bin?collection=rrep&replication=002",
                          data)
    assert st == 201, body
    entry = _entry(port, "/r/rep.bin")
    vid = FileId.parse(entry.chunks[0].file_id).volume_id
    deadline = time.time() + 15
    while time.time() < deadline and len(CommandEnv(master.url).volume_locations(vid)) < 3:
        time.sleep(0.1)
    return data


@pytest.mark.parametrize("fail", [0, 2, 3])
def test_hedge_and_failover_send_the_same_range(stack, replicated, monkeypatch, fail):
    """fail=0: the hedge leg fires at once beside the primary; 2: the primary
    and its failover fail, the third replica serves; 3: all three fail in
    the filer and ``operation.download`` serves. Every chunk GET of the
    fetch carries the view's Range."""
    _, volumes, filers, _ = stack
    port = filers["port"]
    monkeypatch.setenv("SWEED_HEDGE_DELAY_MS", "0")
    monkeypatch.setenv("SWEED_HEDGE_BUDGET", "1")
    hedge.STATS.reset()
    entry = _entry(port, "/r/rep.bin")
    offset, size = CHUNK + 12345, 54321
    tally = Tally(monkeypatch, [v.port for v in volumes], fail=fail,
                  slow=0.3 if fail == 0 else 0.0)
    assert port._read_range(entry, offset, size) == replicated[offset:offset + size]
    want = f"bytes={offset - CHUNK}-{offset - CHUNK + size - 1}"
    assert len(tally.calls) >= (2 if fail == 0 else fail + 1)
    assert {rng for _, rng, _ in tally.calls} == {want}
    assert len({url.split("/")[2] for url, _, _ in tally.calls}) >= 2
    time.sleep(0.2)  # a losing hedge leg may still be in flight


def test_native_hedge_sends_the_same_range(stack, replicated, monkeypatch):
    _, volumes, filers, _ = stack
    port = filers["port"]
    monkeypatch.setenv("SWEED_HEDGE_DELAY_MS", "0")
    monkeypatch.setenv("SWEED_HEDGE_BUDGET", "1")
    hedge.STATS.reset()
    http_bytes("GET", f"http://{port.url}/r/rep.bin")  # the vid map learns the replicas
    offset, size = CHUNK + 777, 100_000
    tally = Tally(monkeypatch, [v.port for v in volumes], fail=1)
    assert _http_range(port, "/r/rep.bin", offset, size) == (
        206, replicated[offset:offset + size])
    want = f"bytes={offset - CHUNK}-{offset - CHUNK + size - 1}"
    assert len({url.split("/")[2] for url, _, _ in tally.calls}) >= 2
    assert {rng for _, rng, _ in tally.calls} == {want}


def test_sealed_ranges_equal_the_jax_filer(stack, monkeypatch):
    """After ec.encode with shards {0, 3, 10, 13} lost, every range reads
    equal through both filers, and the sealed volumes send the port no more
    than the range and one cacheable chunk for the plain and gzip'd objects
    (the volume servers rebuild only the bytes asked for)."""
    master, volumes, filers, objects = stack
    vids = set()
    for f in filers.values():
        for path in objects:
            meta = http_json("GET", f"http://{f.url}{path}?meta=true")
            vids |= {FileId.parse(c["file_id"]).volume_id for c in meta["chunks"]}
    env = CommandEnv(master.url)
    for vid in sorted(vids):
        run_command(env, f"ec.encode -volumeId={vid} -collection={COLLECTION}")
    for vid in sorted(vids):
        for sid, holders in env.ec_shard_locations(vid).items():
            if sid in LOST:
                for h in holders:
                    st, body = http_bytes(
                        "POST", f"http://{h}/admin/ec/delete_shards?volume={vid}"
                                f"&collection={COLLECTION}&shards={sid}")
                    assert st == 200, body
    time.sleep(1.5)  # the delta beats reach the master
    port = filers["port"]
    for path, (data, _) in objects.items():
        for offset, size in _ranges(len(data)):
            want = data[offset:offset + size]
            assert _http_range(filers["jax"], path, offset, size) == (206, want)
            port.chunk_cache.mem._lru.clear()
            port.chunk_cache.mem._bytes = 0
            assert _http_range(port, path, offset, size) == (206, want), (path, offset)
            port.chunk_cache.mem._lru.clear()
            port.chunk_cache.mem._bytes = 0
            tally = Tally(monkeypatch, [v.port for v in volumes])
            assert _stream(port, path, offset, size) == want
            if path != "/r/cipher.bin":
                assert tally.sent() <= size + 4 * MiB, (path, offset, size)
            monkeypatch.undo()
