"""The native turbo data plane of the port's volume server against the JAX
package's.

Both servers run on their defaults: the engine (built from each package's
own ``turbo.cpp``) owns the public port and proxies every other route to the
Python daemon. The reference's ``tests/test_turbo.py`` cases run against
both, and each answer (status, headers without ``Date``, body) must be the
same; the same uploads must leave .dat files equal with the append and
last-modified timestamps masked, and .idx files equal byte for byte. The
malformed requests of ``tests/test_turbo_fuzz.py`` must get the same bytes
back from both (``Date`` lines dropped).
"""

import ctypes
import gzip
import os
import random
import secrets
import tempfile
import threading

import pytest

from seaweedfs_tpu import operation
from seaweedfs_tpu.native import turbo as jturbo
from seaweedfs_tpu.security import gen_jwt
from seaweedfs_tpu_torch.storage import turbo as pturbo
from serving_pair import (
    VID,
    both,
    free_port,
    masked_dat,
    pair,
    raw_exchange,
    request,
    strip_dates,
    wait,
)


def _fid(key: int, cookie: int = 0x1234ABCD) -> str:
    return f"{VID},{key:x}{cookie:08x}"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pair(tmp_path_factory) as n:
        for node in n.values():
            assert node.vs.turbo is not None, node.kind
        yield n


def _same(answers: dict):
    assert answers["port"] == answers["jax"]
    return answers["port"]


def _counters(nodes):
    return {k: n.vs.turbo.counters() for k, n in nodes.items()}


def test_engine_owns_the_public_port_and_status_says_so(nodes):
    port = nodes["port"]
    assert port.vs.turbo_status()["on"] is True
    st, _, body = request(port.url, "GET", "/status")
    assert st == 200 and b'"turbo": {"on": true' in body
    assert pturbo.library_path().startswith(os.path.dirname(pturbo.SOURCE))


def test_native_roundtrip_and_counters(nodes):
    before = _counters(nodes)
    payload = secrets.token_bytes(4096)  # incompressible: stays native
    st, _, body = _same(both(nodes, "POST", "/" + _fid(0x101), payload))
    assert st == 201 and b'"unchanged": false' in body
    assert _same(both(nodes, "GET", "/" + _fid(0x101)))[2] == payload
    assert _same(both(nodes, "HEAD", "/" + _fid(0x101)))[0] == 200
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["posts"] == before[k]["posts"] + 1
        assert after[k]["gets"] == before[k]["gets"] + 2
        assert after[k]["proxied"] == before[k]["proxied"]
    # the same bytes again: unchanged, nothing appended
    assert b'"unchanged": true' in _same(both(nodes, "POST", "/" + _fid(0x101), payload))[2]


def test_pipelined_requests_one_socket(nodes):
    payloads = [secrets.token_bytes(256) for _ in range(4)]
    fids = [_fid(0x201 + i) for i in range(4)]
    for fid, data in zip(fids, payloads):
        assert _same(both(nodes, "POST", "/" + fid, data))[0] == 201
    got = {}
    for k, n in nodes.items():
        req = b"".join(f"GET /{fid} HTTP/1.1\r\nHost: {n.url}\r\n\r\n".encode()
                       for fid in fids)
        got[k] = strip_dates(raw_exchange(n.vs.port, req, read_timeout=1.0))
    assert got["port"] == got["jax"]
    assert got["port"].count(b"HTTP/1.1 200") == 4
    assert all(got["port"].count(p) == 1 for p in payloads)


def test_admin_routes_proxy_through_the_public_port(nodes):
    before = _counters(nodes)
    answers = both(nodes, "GET", "/admin/volume_status?volume=%d" % VID)
    assert answers["port"][0] == answers["jax"][0] == 200
    for k, n in nodes.items():
        st, _, body = request(n.url, "GET", "/metrics")
        assert st == 200 and b"volume_server" in body, k
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["proxied"] == before[k]["proxied"] + 2


def test_exotic_write_headers_native(nodes):
    payload = secrets.token_bytes(128)
    hdrs = {"X-Sweed-Name": "hello.bin", "X-Sweed-Mime": "application/x-t"}
    before = _counters(nodes)
    assert _same(both(nodes, "POST", "/" + _fid(0x301), payload, hdrs))[0] == 201
    assert _same(both(nodes, "GET", "/" + _fid(0x301)))[2] == payload
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["posts"] == before[k]["posts"] + 1
    # the Python read path, through the engine's map, sees the same fields
    from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_MIME, FLAG_HAS_NAME, Needle

    v = nodes["port"].vs.store.find_volume(VID)
    n = Needle(id=0x301)
    v.read_needle(n)
    assert n.data == payload and n.cookie == 0x1234ABCD
    assert n.has(FLAG_HAS_NAME) and n.name == b"hello.bin"
    assert n.has(FLAG_HAS_MIME) and n.mime == b"application/x-t"
    assert n.last_modified > 0


def test_sub_fid_delta_addressing(nodes):
    base = _fid(0x400)
    blobs = {base if i == 0 else f"{base}_{i}": secrets.token_bytes(64) for i in range(5)}
    for fid, blob in blobs.items():
        assert _same(both(nodes, "POST", "/" + fid, blob))[0] == 201
    for fid, blob in blobs.items():
        assert _same(both(nodes, "GET", "/" + fid))[2] == blob
    assert _same(both(nodes, "GET", f"/{base}_abc"))[0] == 500


def test_ttl_write_proxies_to_python(nodes):
    before = _counters(nodes)
    assert _same(both(nodes, "POST", f"/{_fid(0x501)}?ttl=1m", b"ephemeral"))[0] == 201
    assert _same(both(nodes, "GET", "/" + _fid(0x501)))[2] == b"ephemeral"
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["proxied"] == before[k]["proxied"] + 1  # the POST; the GET is native


def test_read_only_volume_rejects_native_post(nodes):
    assert _same(both(nodes, "POST", "/" + _fid(0x601), b"x" * 99))[0] == 201
    for n in nodes.values():
        assert n.vs.store.mark_volume_readonly(VID)
    st, _, body = _same(both(nodes, "POST", "/" + _fid(0x601), b"nope"))
    assert st == 500 and b"read only" in body
    st, _, body = _same(both(nodes, "DELETE", "/" + _fid(0x601)))
    assert st == 500 and b"read only" in body
    for n in nodes.values():
        assert n.vs.store.mark_volume_writable(VID)
    assert _same(both(nodes, "POST", "/" + _fid(0x601), b"yes"))[0] == 201
    assert _same(both(nodes, "GET", "/" + _fid(0x601)))[2] == b"yes"


def test_compressed_needles_served_natively(nodes):
    text = b"the quick brown fox " * 200
    blob = gzip.compress(text, mtime=0)
    multi = gzip.compress(b"first-member " * 40, mtime=0) + gzip.compress(
        b"second-member " * 40, mtime=0)
    for key, body in ((0x701, blob), (0x702, multi)):
        assert _same(both(nodes, "POST", "/" + _fid(key), body,
                          {"Content-Encoding": "gzip"}))[0] == 201
    before = _counters(nodes)
    assert _same(both(nodes, "GET", "/" + _fid(0x701)))[2] == text
    st, hdrs, raw = _same(both(nodes, "GET", "/" + _fid(0x701), None,
                               {"Accept-Encoding": "gzip"}))
    assert st == 200 and ("Content-Encoding", "gzip") in hdrs and raw == blob
    assert _same(both(nodes, "GET", "/" + _fid(0x702)))[2] == (
        b"first-member " * 40 + b"second-member " * 40)
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["gets"] == before[k]["gets"] + 3
        assert after[k]["proxied"] == before[k]["proxied"], "must not proxy"


@pytest.mark.parametrize("case", [
    {}, {"Range": "bytes=2-9"}, {"Range": "bytes=-5"}, {"Range": "bytes=99999-"},
    {"Range": "bytes=5-2"}, {"Range": "bytes=0-0,3-4"},
])
def test_reads_answer_the_same(nodes, case):
    data = bytes(range(256)) * 3
    for n in nodes.values():
        if n.vs.store.find_volume(VID).nm.get(0x801) is None:
            assert request(n.url, "POST", "/" + _fid(0x801), data)[0] == 201
    _same(both(nodes, "GET", "/" + _fid(0x801), None, case))
    _same(both(nodes, "HEAD", "/" + _fid(0x801), None, case))
    # a missing needle, a wrong cookie, an unknown volume
    _same(both(nodes, "GET", "/" + _fid(0x8FF), None, case))
    _same(both(nodes, "GET", "/" + _fid(0x801, cookie=0x1), None, case))
    _same(both(nodes, "GET", "/77," + _fid(0x801).split(",")[1], None, case))


def test_delete_native_then_404(nodes):
    assert _same(both(nodes, "POST", "/" + _fid(0x901), b"gone soon"))[0] == 201
    before = _counters(nodes)
    st, _, body = _same(both(nodes, "DELETE", "/" + _fid(0x901)))
    assert st == 202
    assert _same(both(nodes, "GET", "/" + _fid(0x901)))[0] == 404
    assert _same(both(nodes, "DELETE", "/" + _fid(0x901)))[0] == 202
    after = _counters(nodes)
    for k in nodes:
        assert after[k]["deletes"] >= before[k]["deletes"] + 1


def test_detach_reattach_and_the_files(nodes):
    """A compaction detaches the engine, compacts in Python and attaches
    again; needles written before and after read back the same, and the
    files the two packages hold are equal with the timestamps masked."""
    payload = secrets.token_bytes(512)
    assert _same(both(nodes, "POST", "/" + _fid(0xA01), payload))[0] == 201
    assert _same(both(nodes, "POST", "/" + _fid(0xA02), payload[:100]))[0] == 201
    assert _same(both(nodes, "DELETE", "/" + _fid(0xA02)))[0] == 202
    for n in nodes.values():
        v = n.vs.store.find_volume(VID)
        assert v.turbo is not None
        v.compact()
        assert v.turbo is not None, n.kind
    assert _same(both(nodes, "POST", "/" + _fid(0xA03), payload[:200]))[0] == 201
    for key, want in ((0xA01, payload), (0xA03, payload[:200])):
        assert _same(both(nodes, "GET", "/" + _fid(key)))[2] == want
    assert _same(both(nodes, "GET", "/" + _fid(0xA02)))[0] == 404
    files = {}
    for k, n in nodes.items():
        n.vs.store.find_volume(VID).sync()
        base = os.path.join(n.dir, str(VID))
        with open(base + ".idx", "rb") as f:
            files[k] = (masked_dat(base + ".dat"), f.read())
    assert files["port"] == files["jax"]


def test_idx_offset_cap_guard():
    """Both engines refuse an append whose offset the 4-byte .idx flavour
    cannot hold, and persist no truncated entry."""
    for mod in (jturbo, pturbo):
        lib = mod._load() if mod is jturbo else mod.load()
        h = lib.turbo_start(b"127.0.0.1", free_port(), b"127.0.0.1", 1, 1)
        assert h
        try:
            with tempfile.TemporaryDirectory() as d:
                dat, idx = os.path.join(d, "1.dat"), os.path.join(d, "1.idx")
                with open(dat, "wb") as f:
                    f.truncate(32 * 1024 * 1024 * 1024)  # sparse, at the cap
                open(idx, "wb").close()
                assert lib.turbo_register(h, 1, dat.encode(), idx.encode(), 3, 4, 1, 0) == 0
                rec = b"\x00" * 40
                out = ctypes.c_ulonglong()
                assert lib.turbo_append(h, 1, 42, rec, len(rec), 24, 0, ctypes.byref(out)) != 0
                assert os.path.getsize(idx) == 0
        finally:
            lib.turbo_stop(h)


def test_native_jwt_enforcement(tmp_path_factory):
    with pair(tmp_path_factory, jwt_signing_key="wkey", jwt_read_key="rkey") as n2:
        for n in n2.values():
            assert n.vs.turbo is not None, "jwt keys must not disable the engine"
        fid = _fid(0xB01)
        wtok = gen_jwt("wkey", fid)
        payload = secrets.token_bytes(777)
        assert _same(both(n2, "POST", "/" + fid, payload))[0] == 401
        assert _same(both(n2, "POST", "/" + fid, payload,
                          {"Authorization": f"Bearer {wtok}"}))[0] == 201
        assert _same(both(n2, "GET", "/" + fid))[0] == 401
        rtok = gen_jwt("rkey", fid)
        assert _same(both(n2, "GET", f"/{fid}?auth={rtok}"))[2] == payload
        other = gen_jwt("rkey", "99,deadbeef00")
        assert _same(both(n2, "GET", f"/{fid}?auth={other}"))[0] == 401
        stale = gen_jwt("rkey", fid, expires_seconds=-5)
        assert _same(both(n2, "GET", f"/{fid}?auth={stale}"))[0] == 401
        assert _same(both(n2, "DELETE", "/" + fid))[0] == 401
        for n in n2.values():
            c = n.vs.turbo.counters()
            assert c["posts"] >= 1 and c["gets"] >= 1 and c["proxied"] <= 1


@pytest.mark.parametrize("kind", ["jax", "port"])
def test_vacuum_under_concurrent_native_load(tmp_path_factory, kind):
    """A compaction detaches and attaches the engine while native reads and
    writes keep arriving; no request may go wrong or vanish."""
    with pair(tmp_path_factory, assign_vid=False) as n2:
        node = n2[kind]
        ms = node.master.url
        seed = {}
        for _ in range(30):
            data = secrets.token_bytes(256)
            seed[operation.submit(ms, data)] = data
        victims = list(seed)[:10]
        for fid in victims:
            assert request(node.url, "DELETE", "/" + fid)[0] == 202
            del seed[fid]
        stop = threading.Event()
        errors, written = [], {}

        def hammer():
            try:
                while not stop.is_set():
                    data = secrets.token_bytes(128)
                    fid = operation.submit(ms, data)
                    written[fid] = data
                    if operation.download(ms, fid) != data:
                        errors.append(f"read-back mismatch {fid}")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            wait(lambda: len(written) > 5)
            for v in [v for loc in node.vs.store.locations for v in list(loc.volumes.values())]:
                v.compact()
                assert v.turbo is not None, "attached again after the compaction"
        finally:
            stop.set()
            t.join(timeout=10)
        assert not errors, errors[:3]
        assert len(written) > 5
        for fid, data in list(seed.items()) + list(written.items()):
            assert operation.download(ms, fid) == data, fid
        for fid in victims:
            assert request(node.url, "GET", "/" + fid)[0] == 404


def test_metrics_expose_native_counters(nodes):
    assert _same(both(nodes, "POST", "/" + _fid(0xC01), b"m" * 64))[0] == 201
    _same(both(nodes, "GET", "/" + _fid(0xC01)))
    for k, n in nodes.items():
        st, _, body = request(n.url, "GET", "/metrics")
        text = body.decode()
        assert st == 200
        for op in ("get", "post", "delete", "proxied"):
            assert f'volume_server_turbo_requests_total{{op="{op}"}}' in text, (k, op)


# -- the malformed-request corpus of tests/test_turbo_fuzz.py --------------
CRAFTED = [
    b"",
    b"\r\n\r\n",
    b"GET\r\n\r\n",
    b"GET /3,0000000000 HTTP/1.1\r\n\r\n",
    b"BREW /3,0102030405 HTTP/1.1\r\n\r\n",
    b"GET /" + b"9" * 30 + b",00" * 14 + b" HTTP/1.1\r\n\r\n",
    b"POST /3,0102030405 HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"POST /3,0102030405 HTTP/1.1\r\nContent-Length: 99999999999999\r\n\r\n",
    b"POST /3,0102030405 HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n0\r\n\r\n",
    b"GET /3,0102030405 HTTP/1.1\r\nRange: bytes=5-2\r\n\r\n",
    b"GET /3,zzzz HTTP/1.1\r\n\r\n",
    b"GET /3,0102030405_abc HTTP/1.1\r\n\r\n",
    b"X" * 70000,
    b"GET /3,0102030405 HTTP/1.1\r\n" + b"A: B\r\n" * 2000 + b"\r\n",
]


def _junk_corpus():
    rng = random.Random(0x7E57)
    out = []
    for _ in range(40):
        kind = rng.random()
        if kind < 0.4:
            out.append(bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 400))))
        elif kind < 0.7:
            out.append(b"GET /" + str(rng.randint(0, 99)).encode() + b","
                       + bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 40)))
                       + b" HTTP/1.1\r\n\r\n")
        else:
            full = b"POST /3,0102030405 HTTP/1.1\r\nContent-Length: 100\r\n\r\n" + b"y" * 100
            out.append(full[: rng.randint(1, len(full) - 1)])
    return out


def test_malformed_requests_get_the_same_answers(nodes):
    canary = secrets.token_bytes(128)
    assert _same(both(nodes, "POST", "/" + _fid(0xD01), canary))[0] == 201
    for i, payload in enumerate(CRAFTED + _junk_corpus()):
        got = {k: strip_dates(raw_exchange(n.vs.port, payload, read_timeout=0.3))
               for k, n in nodes.items()}
        assert got["port"] == got["jax"], (i, payload[:80])
        if i % 8 == 7:
            assert _same(both(nodes, "GET", "/" + _fid(0xD01)))[2] == canary, i
