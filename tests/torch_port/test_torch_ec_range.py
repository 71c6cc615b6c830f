"""A ``Range`` on a needle of an EC volume with shards {0, 3, 10, 13} lost,
held against the JAX package's volume server.

One port ``Store`` (cpu codec) writes a volume of needles above a small
block (1.2-6 MiB of random bytes), a small one, a gzip'd one and a chunk
manifest, and seals it; its EC files without the four lost shards go to a
port and a JAX volume server beside one port master, each with the native
engine on its public port (an EC ``GET`` is proxied to the daemon with its
``Range``). No server holds a lost shard, so each read on one reconstructs.

The port reads only the header and data size, the flags byte and the
range (``storage.store.EcNeedleReader``); the JAX package reads the whole
needle and slices it. For seeded ranges, open and suffix ranges, the whole
data, an unsatisfiable and a malformed range, a wrong cookie, a missing
needle, the gzip'd needle with and without ``Accept-Encoding: gzip`` and
the manifest resolved and raw: status, body and the range headers must be
equal, the body equal to the stored bytes, and the port must reconstruct
fewer times than the JAX package over the same reads. Heat counts each
read once in both.
"""

import gzip
import json
import shutil
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.stats import heat as jheat
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.server.http_util import http_bytes_headers
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.stats import heat as pheat
from seaweedfs_tpu_torch.storage.needle import (
    FLAG_IS_CHUNK_MANIFEST,
    FLAG_IS_COMPRESSED,
    Needle,
)
from seaweedfs_tpu_torch.storage.store import Store

VID, COOKIE = 7, 0x5EA1
LOST = (0, 3, 10, 13)
MiB = 1 << 20
LARGE = range(1, 7)  # needle ids above a small block
SMALL, GZIPPED, MANIFEST = 7, 8, 9
HEADERS = ("Content-Range", "Accept-Ranges", "Content-Encoding", "Content-Length")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fid(nid, cookie=COOKIE):
    return f"{VID},{nid:x}{cookie:08x}"


def _needles():
    rng = np.random.default_rng(18)
    out = {nid: rng.bytes(int(rng.integers(int(1.2 * MiB), 6 * MiB))) for nid in LARGE}
    out[SMALL] = rng.bytes(200_000)
    # hex text: gzip halves it, so the stored record stays above a small block
    out[GZIPPED] = rng.bytes(2 * MiB).hex().encode()
    chunks = [{"fid": fid(SMALL), "offset": i * 1000, "size": 1000} for i in range(25_000)]
    out[MANIFEST] = json.dumps({"name": "m.bin", "mime": "application/octet-stream",
                                "size": 25_000 * 1000, "chunks": chunks}).encode()
    return out


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ec_range")
    blobs = _needles()
    src = tmp / "src"
    store = Store([str(src)], ec_backend="cpu")
    try:
        store.add_volume(VID)
        for nid, data in blobs.items():
            n = Needle(cookie=COOKIE, id=nid, data=data)
            if nid == GZIPPED:
                n.data = gzip.compress(data, mtime=0)
                n.set_flag(FLAG_IS_COMPRESSED)
            if nid == MANIFEST:
                n.set_flag(FLAG_IS_CHUNK_MANIFEST)
            store.write_volume_needle(VID, n)
        store.find_volume(VID).sync()
        store.ec_encode_volume(VID)
    finally:
        store.close()
    master = MasterServer(port=free_port(), node_timeout=60).start()
    out = {}
    for kind, cls, backend in (("jax", JVolumeServer, "numpy"), ("port", PVolumeServer, "cpu")):
        d = tmp / kind
        d.mkdir()
        for ext in [shard_ext(s) for s in range(14) if s not in LOST] + [".ecx", ".vif"]:
            shutil.copy(src / f"{VID}{ext}", d / f"{VID}{ext}")
        vs = cls([str(d)], port=free_port(), master_url=master.url, pulse_seconds=0.5,
                 ec_backend=backend).start()
        vs.store.remote_fetch_attempts = 1
        heat = (jheat if kind == "jax" else pheat).EwmaHeat(halflife=1e12)
        vs.store.ec_read_heat[VID] = heat
        out[kind] = vs
    time.sleep(1.0)  # both announce their shards
    yield out, blobs
    for vs in out.values():
        vs.stop()
    master.stop()


def _count_reconstructs(vs, monkeypatch):
    codec = vs.store.ec_codec
    calls = [0]
    real = codec.reconstruct

    def counting(shards, data_only=False):
        calls[0] += 1
        return real(shards, data_only=data_only)

    monkeypatch.setattr(codec, "reconstruct", counting)
    return calls


def _get(vs, nid, headers, cookie=COOKIE, query=""):
    status, body, hdrs = http_bytes_headers(
        "GET", f"http://127.0.0.1:{vs.port}/{fid(nid, cookie)}{query}", headers=headers)
    lower = {k.lower(): v for k, v in hdrs.items()}
    return status, body, {k: lower.get(k.lower()) for k in HEADERS}


def _ranges(size, rng):
    out = ["bytes=0-0", f"bytes={size - 1}-{size - 1}", "bytes=-1", "bytes=-70000",
           f"bytes={size - 5000}-", "bytes=0-", f"bytes=0-{size - 1}", f"bytes={size}-",
           "bytes=x-y", "bytes=0-1,4-5"]
    for _ in range(6):
        a = int(rng.integers(0, size - 1))
        out.append(f"bytes={a}-{min(size - 1, a + int(rng.integers(1, MiB)))}")
    return out


def _expect(rng_spec, data):
    """What either server must send for a range over plain ``data``."""
    spec = rng_spec[len("bytes="):]
    if "," in spec or not spec.replace("-", "").isdigit():
        return 200, data
    a, _, b = spec.partition("-")
    if a == "":
        return 206, data[-int(b):]
    if int(a) >= len(data):
        return 416, b""
    return 206, data[int(a): int(b) + 1 if b else len(data)]


def test_ranges_of_large_needles_equal_with_fewer_reconstructs(servers, monkeypatch):
    vss, blobs = servers
    calls = {k: _count_reconstructs(vs, monkeypatch) for k, vs in vss.items()}
    rng = np.random.default_rng(5)
    reads = 0
    for nid in LARGE:
        for spec in _ranges(len(blobs[nid]), rng):
            got = {k: _get(vs, nid, {"Range": spec}) for k, vs in vss.items()}
            assert got["port"] == got["jax"], (nid, spec)
            assert got["port"][:2] == _expect(spec, blobs[nid]), (nid, spec)
            reads += 1
    assert calls["jax"][0] > 0
    assert calls["port"][0] < calls["jax"][0], calls
    # every GET counted once for the heat, in both
    heat = {k: vs.store.ec_read_heat[VID].value() for k, vs in vss.items()}
    assert round(heat["port"], 6) == round(heat["jax"], 6)


def test_partial_range_reconstructs_only_its_intervals(servers, monkeypatch):
    """A 1-byte range costs at most three reconstructions (the header, the
    flags byte and the byte), where the JAX package rebuilds every lost
    interval of the needle."""
    vss, blobs = servers
    worst = max(LARGE, key=lambda n: len(blobs[n]))
    size = len(blobs[worst])
    seen = {}
    for k, vs in vss.items():
        calls = _count_reconstructs(vs, monkeypatch)
        for at in range(0, size, size // 16):
            assert _get(vs, worst, {"Range": f"bytes={at}-{at}"})[1] == blobs[worst][at:at + 1]
        seen[k] = calls[0]
    assert seen["port"] <= 3 * 16
    assert seen["port"] < seen["jax"], seen


@pytest.mark.parametrize("case", ["wrong_cookie", "missing", "small", "gzip_plain",
                                  "gzip_accepted", "manifest", "manifest_raw"])
def test_edge_cases_equal(servers, case):
    vss, blobs = servers
    args = {
        "wrong_cookie": (LARGE[0], {"Range": "bytes=10-20"}, COOKIE + 1, ""),
        "missing": (99, {"Range": "bytes=10-20"}, COOKIE, ""),
        "small": (SMALL, {"Range": "bytes=1000-1999"}, COOKIE, ""),
        "gzip_plain": (GZIPPED, {"Range": "bytes=100000-300000"}, COOKIE, ""),
        "gzip_accepted": (GZIPPED, {"Range": "bytes=100000-300000",
                                    "Accept-Encoding": "gzip"}, COOKIE, ""),
        "manifest": (MANIFEST, {"Range": "bytes=5500-7499"}, COOKIE, ""),
        "manifest_raw": (MANIFEST, {"Range": "bytes=10-5000"}, COOKIE, "?cm=false"),
    }[case]
    nid, headers, cookie, query = args
    got = {k: _get(vs, nid, headers, cookie, query) for k, vs in vss.items()}
    assert got["port"] == got["jax"]
    status, body, _ = got["port"]
    if case in ("wrong_cookie", "missing"):
        assert status == 404
    elif case == "gzip_plain":
        assert (status, body) == (206, blobs[GZIPPED][100000:300001])
    elif case == "gzip_accepted":
        assert status == 200 and gzip.decompress(body) == blobs[GZIPPED]
    elif case == "manifest":
        piece = blobs[SMALL][:1000]
        assert (status, body) == (206, (piece[500:] + piece + piece[:500]))
    elif case == "manifest_raw":
        assert (status, body) == (206, blobs[MANIFEST][10:5001])
    else:
        assert (status, body) == (206, blobs[SMALL][1000:2000])
