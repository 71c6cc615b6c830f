"""The port's filer over a port cluster, held against the JAX package's filer
over the same cluster.

One port master and three port volume servers (``ec_backend="cpu"``, the
native engine on their public ports) serve two filers side by side: the
JAX package's ``FilerServer`` and the port's, both at a 1 MiB chunk size
(so that the multi-chunk cases stay small), ``read_window`` 8,
``write_window`` 4 and no chunk cache. Every case of the JAX package's
``tests/test_filer_server.py`` and ``tests/test_filer_pipeline.py`` runs
against each filer (``kind`` = ``jax`` or ``port``). Then, across the two:
the same writes give equal bytes, listings and chunk layouts (a manifest
included); a cipher'd entry written through one filer decrypts through
the other; the same mutations give equal ``/_meta/events``; and after the
port shell's ``ec.encode`` of the filers' volumes, with four shards
deleted, every file reads back equal through both.
"""

import contextlib
import http.client
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu.util import faultpoints as jfaultpoints
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.util import faultpoints as pfaultpoints

from serving_pair import raw_exchange

CHUNK = 1 << 20
KINDS = ("jax", "port")
FAULTS = {"jax": jfaultpoints, "port": pfaultpoints}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("filers")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volumes = [VolumeServer([str(tmp / f"srv{i}")], port=free_port(), master_url=master.url,
                            max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
               for i in range(3)]
    kw = dict(master_url=master.url, chunk_size=CHUNK, chunk_cache_mem_mb=0,
              read_window=8, write_window=4)
    filers = {"jax": JFilerServer(port=free_port(), **kw).start(),
              "port": PFilerServer(port=free_port(), query_backend="cpu", **kw).start()}
    time.sleep(0.6)
    yield master, volumes, filers
    # the JAX package's asyncio server lingers ~10 s on an idle keep-alive
    # peer when stopped: beside the rest of the teardown
    threading.Thread(target=filers["jax"].stop, daemon=True).start()
    filers["port"].stop()
    for v in volumes:
        v.stop()
    master.stop()


@pytest.fixture(params=KINDS)
def one(request, cluster):
    """(kind, master, filer) for each filer in turn."""
    master, _, filers = cluster
    return request.param, master, filers[request.param]


def blob_of(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def ranged_get(filer, path, spec):
    req = urllib.request.Request(f"http://{filer.url}{path}")
    req.add_header("Range", f"bytes={spec}")
    with urllib.request.urlopen(req) as resp:
        return resp.status, resp.read()


@contextlib.contextmanager
def read_window(filer, n):
    old = filer.read_window
    filer.read_window = n
    try:
        yield
    finally:
        filer.read_window = old


# -- the reference's test_filer_server.py cases, against each filer ---------
def test_small_file_roundtrip(one):
    _, _, filer = one
    status, _ = http_bytes("POST", f"http://{filer.url}/docs/hello.txt", b"hi filer")
    assert status == 201
    status, data = http_bytes("GET", f"http://{filer.url}/docs/hello.txt")
    assert status == 200 and data == b"hi filer"


def test_multi_chunk_file(one):
    _, _, filer = one
    blob = blob_of(4 * CHUNK + 1000, 0)
    status, resp = http_bytes("POST", f"http://{filer.url}/big/file.bin", blob)
    assert status == 201 and json.loads(resp)["chunks"] == 5
    status, data = http_bytes("GET", f"http://{filer.url}/big/file.bin")
    assert status == 200 and data == blob


def test_range_read(one):
    _, _, filer = one
    blob = bytes(range(256)) * (CHUNK * 3 // 256)
    http_bytes("POST", f"http://{filer.url}/r/range.bin", blob)
    status, data = ranged_get(filer, "/r/range.bin", f"{CHUNK - 6}-{CHUNK + 9}")
    assert status == 206 and data == blob[CHUNK - 6:CHUNK + 10]


def test_directory_listing(one):
    _, _, filer = one
    for name in ("a.txt", "b.txt"):
        http_bytes("POST", f"http://{filer.url}/listdir/{name}", b"x")
    r = http_json("GET", f"http://{filer.url}/listdir/")
    assert [e["name"] for e in r["entries"]] == ["a.txt", "b.txt"]
    assert all(not e["is_directory"] for e in r["entries"])


def test_overwrite_and_delete_purges_chunks(one):
    _, _, filer = one
    blob1, blob2 = b"version one" * 1000, b"version two!" * 1000
    http_bytes("POST", f"http://{filer.url}/ow/f.txt", blob1)
    http_bytes("POST", f"http://{filer.url}/ow/f.txt", blob2)
    assert http_bytes("GET", f"http://{filer.url}/ow/f.txt")[1] == blob2
    assert http_bytes("DELETE", f"http://{filer.url}/ow/f.txt")[0] == 200
    assert http_bytes("GET", f"http://{filer.url}/ow/f.txt")[0] == 404


def test_recursive_delete(one):
    _, _, filer = one
    http_bytes("POST", f"http://{filer.url}/tree/x/1.txt", b"1")
    http_bytes("POST", f"http://{filer.url}/tree/x/y/2.txt", b"2")
    assert http_bytes("DELETE", f"http://{filer.url}/tree")[0] == 409
    assert http_bytes("DELETE", f"http://{filer.url}/tree?recursive=true")[0] == 200
    assert http_bytes("GET", f"http://{filer.url}/tree/x/1.txt")[0] == 404


def test_empty_file(one):
    _, _, filer = one
    assert http_bytes("POST", f"http://{filer.url}/empty.txt", b"")[0] == 201
    assert http_bytes("GET", f"http://{filer.url}/empty.txt") == (200, b"")


def test_kv_put_get_delete_http(one):
    _, _, filer = one
    base = f"http://{filer.url}/_kv/sync/offset-a"
    assert http_bytes("PUT", base, b"\x00\x07")[0] == 200
    assert http_bytes("GET", base) == (200, b"\x00\x07")
    assert http_bytes("DELETE", base)[0] == 200
    assert http_bytes("GET", base)[0] == 404
    assert http_bytes("DELETE", f"http://{filer.url}/_kv/sync/never-existed")[0] == 200


def test_http_surface_fuzz_burst(one):
    """Garbled traffic (truncated bodies, bogus Content-Lengths, unknown
    methods, binary garbage, a header bomb) never takes the daemon down or
    wedges the next well-formed request."""
    import random

    _, _, filer = one
    rng = random.Random(7)
    port = int(filer.url.split(":")[1])
    hdr_bomb = b"".join(b"X-%d: y\r\n" % j for j in range(2000))
    payloads = [
        b"POST /fz/a HTTP/1.1\r\nHost: x\r\nContent-Length: 100000\r\n\r\nshort",
        b"POST /fz/b HTTP/1.1\r\nHost: x\r\nContent-Length: -5\r\n\r\n",
        b"BREW /fz/c HTTP/1.1\r\nHost: x\r\n\r\n",
        None,
        b"GET /fz HTTP/1.1\r\nHost: x\r\n" + hdr_bomb + b"\r\n",
        b"GET /fz/missing HTTP/1.1\r\nHost: x\r\n\r\n\x00\xff\x01",
    ]
    for _ in range(36):
        p = payloads[rng.randrange(len(payloads))]
        if p is None:
            p = bytes(rng.randrange(256) for _ in range(200))
        raw_exchange(port, p, read_timeout=0.2, first_byte_timeout=0.3)
    assert http_bytes("POST", f"http://{filer.url}/fz/ok.txt", b"alive")[0] == 201
    assert http_bytes("GET", f"http://{filer.url}/fz/ok.txt") == (200, b"alive")


def test_meta_watch_garbage_params_return_promptly(one):
    _, _, filer = one
    for qs in ("wait_s=nan", "wait_s=-5", "since_ns=zz&limit=yy&wait_s=zz"):
        t0 = time.perf_counter()
        st, _ = http_bytes("GET", f"http://{filer.url}/_meta/events?{qs}")
        assert st == 200, (qs, st)
        assert time.perf_counter() - t0 < 5.0, qs


def test_dot_path_segments_refused_on_write(one):
    _, _, filer = one
    for path in ("/b/../x", "/b/./x", "/../x", "/b/..", "/b/../"):
        st, body = http_bytes("POST", f"http://{filer.url}{path}", b"data")
        assert st == 400, (path, st, body[:80])
    assert http_bytes("POST", f"http://{filer.url}/ok.txt", b"d")[0] == 201
    assert http_json("POST", f"http://{filer.url}/ok.txt?mv.to=/b/../stolen.txt").get("error")
    assert http_bytes("POST", f"http://{filer.url}/b/..x.txt", b"d")[0] == 201
    assert http_bytes("GET", f"http://{filer.url}/b/..x.txt") == (200, b"d")


def test_negative_query_ints_fall_back_to_default(one):
    kind, _, filer = one
    cls = type(filer)
    assert cls._qint({"limit": "-5"}, "limit", 1000) == 1000
    assert cls._qint({"limit": "7"}, "limit", 1000) == 7
    assert cls._qint({"limit": "zz"}, "limit", 42) == 42
    assert cls._qint({}, "limit", 42) == 42
    assert cls._qint({"limit": "0"}, "limit", 42) == 0
    http_bytes("POST", f"http://{filer.url}/neg/sentinel.txt", b"x")
    st, body = http_bytes("GET", f"http://{filer.url}/_meta/events?limit=-1")
    assert st == 200
    assert any((e.get("new_entry") or {}).get("full_path") == "/neg/sentinel.txt"
               for e in json.loads(body)["events"]), kind


# -- the reference's test_filer_pipeline.py cases, against each filer -------
def test_reads_byte_identical_window_1_vs_8(one):
    _, _, filer = one
    blob = blob_of(10 * CHUNK + 13, 1)
    assert http_bytes("POST", f"http://{filer.url}/pipe/plain.bin", blob)[0] == 201
    ranges = [f"0-{len(blob) - 1}", f"{CHUNK - 7}-{3 * CHUNK + 11}",
              f"{5 * CHUNK}-{5 * CHUNK + 99}", f"{len(blob) - 40}-{len(blob) - 1}"]
    for w in (1, 8):
        with read_window(filer, w):
            assert http_bytes("GET", f"http://{filer.url}/pipe/plain.bin") == (200, blob), w
            for spec in ranges:
                lo, hi = (int(x) for x in spec.split("-"))
                assert ranged_get(filer, "/pipe/plain.bin", spec) == (206, blob[lo:hi + 1])


def test_cipher_reads_byte_identical_window_1_vs_8(one):
    _, _, filer = one
    blob = blob_of(6 * CHUNK + 5, 2)
    assert http_bytes("POST", f"http://{filer.url}/pipe/secret.bin?cipher=true", blob)[0] == 201
    for w in (1, 8):
        with read_window(filer, w):
            assert http_bytes("GET", f"http://{filer.url}/pipe/secret.bin") == (200, blob)
            assert ranged_get(filer, "/pipe/secret.bin", f"{CHUNK - 3}-{2 * CHUNK + 3}") == (
                206, blob[CHUNK - 3:2 * CHUNK + 4])


def test_gappy_entry_byte_identical_window_1_vs_8(one):
    _, _, filer = one
    head, tail = blob_of(2 * CHUNK, 3), blob_of(CHUNK // 2, 4)
    http_bytes("POST", f"http://{filer.url}/pipe/head.bin", head)
    http_bytes("POST", f"http://{filer.url}/pipe/tail.bin", tail)
    meta_head = http_json("GET", f"http://{filer.url}/pipe/head.bin?meta=true")
    meta_tail = http_json("GET", f"http://{filer.url}/pipe/tail.bin?meta=true")
    hole_at = 3 * CHUNK
    chunks = list(meta_head["chunks"]) + [dict(c, offset=hole_at + c["offset"])
                                          for c in meta_tail["chunks"]]
    st, _ = http_bytes("POST", f"http://{filer.url}/pipe/gappy.bin?meta=true",
                       json.dumps({"chunks": chunks}).encode())
    assert st == 201
    expected = head + b"\x00" * (hole_at - len(head)) + tail
    for w in (1, 8):
        with read_window(filer, w):
            assert http_bytes("GET", f"http://{filer.url}/pipe/gappy.bin") == (200, expected)
            lo, hi = 2 * CHUNK - 10, hole_at + 9
            assert ranged_get(filer, "/pipe/gappy.bin", f"{lo}-{hi}") == (206, expected[lo:hi + 1])


def test_midstream_fetch_failure_truncates_body(one):
    """A needle deleted under a streaming read: the client sees a short body
    on the keep-alive connection, never a full-length one padded."""
    _, master, filer = one
    blob = blob_of(10 * CHUNK, 5)
    assert http_bytes("POST", f"http://{filer.url}/pipe/holey.bin", blob)[0] == 201
    meta = http_json("GET", f"http://{filer.url}/pipe/holey.bin?meta=true")
    victim = sorted(meta["chunks"], key=lambda c: c["offset"])[5]
    assert operation.delete_file(master.url, victim["file_id"])
    conn = http.client.HTTPConnection(*filer.url.split(":"), timeout=30)
    try:
        conn.request("GET", "/pipe/holey.bin")
        resp = conn.getresponse()
        assert resp.status == 200
        assert int(resp.getheader("Content-Length")) == len(blob)
        try:
            got = resp.read()
            short = len(got) < len(blob)
        except (http.client.IncompleteRead, ConnectionError) as e:
            got, short = getattr(e, "partial", b""), True
        assert short, "a mid-stream fetch failure must truncate the body"
        assert got == blob[:len(got)]
    finally:
        conn.close()


def test_write_fault_mid_window_purges_every_assigned_fid(one):
    kind, _, filer = one
    uploaded, purged = [], []
    orig_upload, orig_purge = filer._upload_piece, filer._purge_chunks

    def spy_upload(piece, offset, *a, assigner=None, record=None):
        def rec(fid):
            uploaded.append(fid)
            if record is not None:
                record(fid)
        return orig_upload(piece, offset, *a, assigner=assigner, record=rec)

    def spy_purge(fids):
        purged.extend(fids)
        return orig_purge(fids)

    filer._upload_piece, filer._purge_chunks = spy_upload, spy_purge
    FAULTS[kind].arm("filer.write.piece", "io-error", skip=2, count=1)
    try:
        st, _ = http_bytes("POST", f"http://{filer.url}/pipe/doomed.bin", blob_of(8 * CHUNK, 6))
        assert st == 500
    finally:
        FAULTS[kind].reset()
        filer._upload_piece, filer._purge_chunks = orig_upload, orig_purge
    assert len(uploaded) >= 3
    assert set(purged) >= set(uploaded), set(uploaded) - set(purged)
    assert http_bytes("GET", f"http://{filer.url}/pipe/doomed.bin")[0] == 404


def test_status_ring_and_reshard(one):
    kind, master, filer = one
    st = http_json("GET", f"http://{filer.url}/_status")
    assert st["pipeline"] == {"read_window": 8, "write_window": 4}
    assert st["master"] == master.url
    assert set(st["sync"]) == {"directions", "totals"}
    ring = http_json("GET", f"http://{filer.url}/_ring")
    assert ring["ring"] == {"depth": 2, "members": [], "self": filer.url, "active": False}
    # a reshard to a target that is not there fails as an error, on both
    st, body = http_bytes("POST", f"http://{filer.url}/_reshard?root=/a&target=127.0.0.1:1")
    assert st == 500 and b"error" in body
    st, body = http_bytes("POST", f"http://{filer.url}/_reshard?root=/a")
    assert st == 400 and b"root and target are required" in body


# -- across the two filers ----------------------------------------------------
def _layout(entry: dict) -> list:
    return [(c["offset"], c["size"], bool(c.get("cipher_key")),
             bool(c.get("is_chunk_manifest"))) for c in entry["chunks"]]


def _listing(url: str, path: str) -> list:
    """Every entry of a directory, three to a page."""
    out, last = [], ""
    while True:
        r = http_json("GET", f"http://{url}{path}?limit=3&lastFileName={last}")
        page = [(e["name"], e["is_directory"], e["size"], e["mime"]) for e in r["entries"]]
        out += page
        if len(page) < 3:
            return out
        last = r["lastFileName"]


def test_same_writes_give_equal_bytes_listings_and_layouts(cluster):
    _, _, filers = cluster
    files = {f"/same/d{i % 3}/f{i}.bin": blob_of(int(s), 10 + i)
             for i, s in enumerate([1, 100, 5000, CHUNK - 1, CHUNK, CHUNK + 1,
                                    3 * CHUNK + 17, 200_000, 7])}
    for f in filers.values():
        f.manifest_batch = 3  # six chunks: two manifest chunks
    try:
        for path, data in files.items():
            for f in filers.values():
                st, body = http_bytes("PUT", f"http://{f.url}{path}", data,
                                      headers={"Content-Type": "application/x-test"})
                assert st == 201, body
        st = {k: http_bytes("PUT", f"http://{f.url}/same/m/six.bin", blob_of(6 * CHUNK, 99))[0]
              for k, f in filers.items()}
        assert st == {"jax": 201, "port": 201}
    finally:
        for f in filers.values():
            f.manifest_batch = 1000
    files["/same/m/six.bin"] = blob_of(6 * CHUNK, 99)
    for path, data in files.items():
        metas = {}
        for k, f in filers.items():
            assert http_bytes("GET", f"http://{f.url}{path}") == (200, data), (k, path)
            metas[k] = http_json("GET", f"http://{f.url}{path}?meta=true")
        assert _layout(metas["jax"]) == _layout(metas["port"]), path
        assert metas["jax"]["extended"] == metas["port"]["extended"], path
        assert metas["jax"]["mime"] == metas["port"]["mime"], path
    assert [c[3] for c in _layout(metas["port"])] == [True, True]
    for d in ("/same/", "/same/d0/", "/same/d1", "/same/m/"):
        assert _listing(filers["jax"].url, d) == _listing(filers["port"].url, d), d


def test_cipher_chunks_decrypt_across_packages(cluster):
    _, _, filers = cluster
    blob = blob_of(2 * CHUNK + 333, 21)
    for src, dst in (("jax", "port"), ("port", "jax")):
        path = f"/xc/from-{src}.bin"
        assert http_bytes("POST", f"http://{filers[src].url}{path}?cipher=true", blob)[0] == 201
        meta = http_json("GET", f"http://{filers[src].url}{path}?meta=true")
        assert all(c["cipher_key"] for c in meta["chunks"])
        # the entry (chunk fids and their keys) handed to the other filer
        st, _ = http_bytes("POST", f"http://{filers[dst].url}{path}?meta=true",
                           json.dumps(meta).encode())
        assert st == 201
        assert http_bytes("GET", f"http://{filers[dst].url}{path}") == (200, blob), (src, dst)
        assert ranged_get(filers[dst], path, f"{CHUNK - 2}-{CHUNK + 2}") == (
            206, blob[CHUNK - 2:CHUNK + 3])


def _norm_event(e: dict) -> tuple:
    def ent(x):
        if x is None:
            return None
        return (x["full_path"], x["is_directory"], x["mime"],
                [(c["offset"], c["size"]) for c in x["chunks"]], x.get("hard_link_counter", 0))
    return (e["directory"], ent(e["old_entry"]), ent(e["new_entry"]), e["delete_chunks"],
            e["signatures"], e["is_from_other_cluster"])


def test_meta_events_equal(cluster):
    _, _, filers = cluster
    since = {k: http_json("GET", f"http://{f.url}/_meta/events?limit=100000")["last_ts_ns"]
             for k, f in filers.items()}
    for f in filers.values():
        u = f"http://{f.url}"
        http_bytes("POST", u + "/ev/a/one.txt", b"1" * 10)
        http_bytes("POST", u + "/ev/a/two.bin", blob_of(CHUNK + 5, 31))
        http_bytes("POST", u + "/ev/a/one.txt", b"2" * 20)
        http_bytes("POST", u + "/ev/a/one.txt?mv.to=/ev/b/uno.txt")
        http_bytes("POST", u + "/ev/b/link.txt?link.to=/ev/b/uno.txt")
        http_bytes("POST", u + "/ev/c/?mkdir=true")
        http_bytes("DELETE", u + "/ev/a?recursive=true")
    got = {}
    for k, f in filers.items():
        r = http_json("GET", f"http://{f.url}/_meta/events?since_ns={since[k]}&limit=1000")
        got[k] = [_norm_event(e) for e in r["events"]]
    assert got["jax"] == got["port"]
    assert len(got["port"]) >= 8


def test_ec_encoded_files_read_through_both_filers(cluster):
    """ec.encode (the port shell) of the volumes the filers wrote into, four
    shards deleted on one server: both filers read every file back equal,
    the vid map having dropped the plain volumes (the master names the
    shard holders on lookup)."""
    master, volumes, filers = cluster
    files = {}
    for k, f in filers.items():
        for i, size in enumerate((700, 90_000, 2 * CHUNK + 9)):
            path = f"/ecf/{k}/f{i}.bin"
            files[path] = blob_of(size, 40 + i)
            st, _ = http_bytes("POST", f"http://{f.url}{path}?collection=ecf", files[path])
            assert st == 201
    vids = set()
    for path in files:
        writer = filers[path.split("/")[2]]  # each filer holds its own entries
        meta = http_json("GET", f"http://{writer.url}{path}?meta=true")
        vids |= {FileId.parse(c["file_id"]).volume_id for c in meta["chunks"]}
    env = CommandEnv(master.url)
    deadline = time.time() + 15
    while time.time() < deadline and not all(env.volume_locations(v) for v in vids):
        time.sleep(0.1)
    for vid in sorted(vids):
        run_command(env, f"ec.encode -volumeId={vid} -collection=ecf")
    for vid in sorted(vids):  # four shards of one holder go
        holder = env.ec_shard_locations(vid)[0][0]
        st, body = http_bytes(
            "POST", f"http://{holder}/admin/ec/delete_shards?volume={vid}"
                    f"&collection=ecf&shards=0,1,2,3")
        assert st == 200, body
    time.sleep(1.5)  # the delta beats reach the master
    for path, data in files.items():
        writer = filers[path.split("/")[2]]
        assert http_bytes("GET", f"http://{writer.url}{path}") == (200, data), path
