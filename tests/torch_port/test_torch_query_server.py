"""``POST /_query`` on the port's volume server, held against the JAX
package's volume server.

A JAX ``MasterServer``, one JAX ``VolumeServer`` and one port
``VolumeServer`` (``ec_backend="cpu"``) run on loopback ports. The same CSV
and JSON-lines needles go to a volume on each; every query body must get
equal JSON from both (SQL, ``where`` dicts, the tolerant ``limit`` and the
``bad sql`` 400 included). The port server's gates are checked in order
(403 IP guard, 401 read JWT from the body, ``?auth=`` or a Bearer header,
400 fid, 404 volume not local). A query on a needle of an EC volume with the
shard that holds it deleted reads through the reconstruction and returns
the rows of the plain volume. A server with the default backend and no card
answers 500 naming the device.
"""

import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.server.http_util import http_bytes
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.ec.encoder import SMALL_BLOCK_SIZE
from seaweedfs_tpu_torch.security import gen_jwt
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import get_actual_size
from seaweedfs_tpu_torch.stats.metrics import QUERY_COUNTERS


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def _csv(seed: int, rows: int) -> bytes:
    rng = np.random.default_rng(seed)
    regions = np.array(["east", "west", "north", "south"])
    reg = regions[rng.integers(0, 4, rows)]
    score = rng.integers(0, 100_000, rows)
    name = rng.integers(0, 10**7, rows)
    lines = [f"{i},{r},{s // 100}.{s % 100:02d},r{n:07d}"
             for i, (r, s, n) in enumerate(zip(reg, score, name))]
    # the exact lane: an exponent, a non-ASCII name and a quoted field
    lines[3] = "3,east,9.97e2,r0000003"
    lines[5] = "5,west,1.5,rø00005"
    lines[-2] = f'{rows - 2},east,"996.1",r0000009'
    return ("id,region,score,name\n" + "\n".join(lines) + "\n").encode()


JSONL = b"\n".join(json.dumps({"a": i, "b": "xyz"[i % 3], "n": {"x": i % 2}}).encode()
                   for i in range(50)) + b"\n"


def _post(url, path, body, headers=None):
    status, data = http_bytes("POST", f"http://{url}{path}", json.dumps(body).encode(),
                              headers=headers or {})
    return status, json.loads(data)


def _put(url, fid, data):
    status, _ = http_bytes("POST", f"http://{url}/{fid}", data)
    assert status == 201, (url, fid, status)


@pytest.fixture
def master():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    yield m
    threading.Thread(target=m.stop, daemon=True).start()  # its stop takes ~10 s


def _server(cls, tmp_path, name, master_url, **kw):
    return cls([str(tmp_path / name)], port=free_port(), master_url=master_url,
               pulse_seconds=0.4, **kw).start()


BODIES = [
    {"input": "csv", "select": ["id", "name"], "where": {"and": [
        {"field": "region", "op": "=", "value": "east"},
        {"field": "score", "op": ">", "value": 950}]}},
    {"input": "csv", "sql": "SELECT * FROM s3object WHERE name LIKE '%123%'"},
    {"input": "csv", "sql": "SELECT id FROM s3object WHERE name LIKE 'r00%'"},
    {"input": "csv", "sql": "SELECT id, name FROM s3object WHERE name < 'r0100000'"},
    {"input": "csv", "sql": "SELECT id FROM s3object WHERE NOT region = 'west' OR score <= 3.5"},
    {"input": "csv", "sql": "SELECT * FROM s3object LIMIT 10"},
    {"input": "csv", "where": {"field": "score", "op": ">=", "value": "9"}, "limit": "-5"},
    {"input": "csv", "where": {"field": "name", "op": "like", "value": "r_00%1"},
     "limit": 7},
    {"input": "csv", "sql": "SELECT id FROM s3object WHERE"},
    {"input": "csv", "sql": "SELECT id FROM s3object LIMIT 2.5"},
]


def test_query_replies_equal_the_reference_server(tmp_path, master, monkeypatch):
    # the JAX server's eager numpy backend; the port server takes its
    # store's device (cpu) whatever the environment says
    monkeypatch.setenv("SWEED_QUERY_BACKEND", "numpy")
    jvs = _server(JVolumeServer, tmp_path, "jax", master.url, ec_backend="numpy")
    pvs = _server(PVolumeServer, tmp_path, "port", master.url, ec_backend="cpu")
    try:
        data = _csv(1, 3000)
        for vs, vid in ((jvs, 11), (pvs, 12)):
            url = f"127.0.0.1:{vs.port}"
            status, _ = http_bytes("POST", f"http://{url}/admin/assign_volume?volume={vid}")
            assert status == 200
            _put(url, f"{vid},0100000007", data)
            _put(url, f"{vid},0200000008", JSONL)
        before = QUERY_COUNTERS["scans"].value(backend="cpu")
        statuses = []
        for body in BODIES + [
                {"input": "json", "where": {"field": "n.x", "op": "=", "value": 1},
                 "select": ["a", "n.x"]},
                {"sql": "SELECT a FROM s3object WHERE b = 'y' LIMIT 3"}]:
            fid_key = "0200000008" if body.get("input", "json") == "json" else "0100000007"
            want = _post(f"127.0.0.1:{jvs.port}", "/_query", dict(body, fid=f"11,{fid_key}"))
            got = _post(f"127.0.0.1:{pvs.port}", "/_query", dict(body, fid=f"12,{fid_key}"))
            assert got == want, body
            statuses.append(want[0])
            if want[0] == 200:
                assert want[1]["count"] > 0, body
            else:
                assert want[1]["error"].startswith("bad sql: "), body
        assert statuses.count(400) == 2
        assert QUERY_COUNTERS["scans"].value(backend="cpu") == before + statuses.count(200)
    finally:
        pvs.stop()
        jvs.stop()


def test_query_gates(tmp_path, master):
    key = "read-secret"
    guarded = _server(PVolumeServer, tmp_path, "guarded", master.url, ec_backend="cpu",
                      whitelist=["10.9.9.9"])
    vs = _server(PVolumeServer, tmp_path, "jwt", master.url, ec_backend="cpu",
                 jwt_read_key=key)
    try:
        url = f"127.0.0.1:{vs.port}"
        http_bytes("POST", f"http://{url}/admin/assign_volume?volume=21")
        fid = "21,0100000007"
        _put(url, fid, _csv(2, 50))
        q = {"fid": fid, "input": "csv", "sql": "SELECT id FROM s3object LIMIT 2"}
        ok = (200, {"rows": [{"id": "0"}, {"id": "1"}], "count": 2})
        assert _post(f"127.0.0.1:{guarded.port}", "/_query", q)[0] == 403
        assert _post(url, "/_query", q) == (401, {"error": "unauthorized read"})
        assert _post(url, "/_query", dict(q, auth=gen_jwt(key, "21,0100000008")))[0] == 401
        assert _post(url, "/_query", dict(q, auth=gen_jwt(key, fid))) == ok
        assert _post(url, f"/_query?auth={gen_jwt(key, fid)}", q) == ok
        assert _post(url, "/_query", q,
                     headers={"Authorization": f"Bearer {gen_jwt(key, fid)}"}) == ok
        bad = dict(q, fid="x,01", auth=gen_jwt(key, "x,01"))
        assert _post(url, "/_query", bad) == (400, {"error": "bad fid 'x,01'"})
        far = dict(q, fid="99,0100000007", auth=gen_jwt(key, "99,0100000007"))
        assert _post(url, "/_query", far) == (404, {"error": "volume 99 not local"})
        gone = dict(q, fid="21,0300000007", auth=gen_jwt(key, "21,0300000007"))
        assert _post(url, "/_query", gone)[0] == 404
    finally:
        vs.stop()
        guarded.stop()


def test_query_on_an_ec_needle_with_its_shard_lost(tmp_path, master):
    vs = _server(PVolumeServer, tmp_path, "ec", master.url, ec_backend="cpu")
    url = f"127.0.0.1:{vs.port}"
    vid = 31
    try:
        http_bytes("POST", f"http://{url}/admin/assign_volume?volume={vid}")
        fids = [str(FileId(vid, i + 1, 0x1234)) for i in range(12)]
        for i, fid in enumerate(fids):  # ~12 x 0.8 MB: the needles cross shards
            _put(url, fid, _csv(10 + i, 24_000))
        q = {"input": "csv", "select": ["id", "name"], "where": {"and": [
            {"field": "region", "op": "=", "value": "east"},
            {"field": "score", "op": ">", "value": 990}]}}
        target = fids[7]
        status, plain = _post(url, "/_query", dict(q, fid=target))
        assert status == 200 and plain["count"] > 0
        with open(tmp_path / "ec" / f"{vid}.idx", "rb") as f:
            entries = {k: (o, s) for k, o, s in idx_mod.iter_index_file(io.BytesIO(f.read()))}

        for path in (f"/admin/readonly?volume={vid}", f"/admin/ec/generate?volume={vid}",
                     f"/admin/ec/mount?volume={vid}", f"/admin/delete_volume?volume={vid}"):
            assert http_bytes("POST", f"http://{url}{path}")[0] == 200, path
        # the data shard that holds the needle's first block (the .dat is
        # under 10 GB, so it is striped in 1 MiB rows over 10 data shards)
        off, size = entries[FileId.parse(target).key]
        shard = (off // SMALL_BLOCK_SIZE) % 10
        end = off + get_actual_size(size, 3)
        assert any((b % 10) == shard for b in range(off // SMALL_BLOCK_SIZE,
                                                     (end - 1) // SMALL_BLOCK_SIZE + 1))
        status, _ = http_bytes("POST", f"http://{url}/admin/ec/delete_shards?volume={vid}"
                                       f"&shards={shard}")
        assert status == 200
        # _fetch_fid finds the needle through the master's lookup, which
        # falls back to the EC volume's shard holders
        assert _wait(lambda: http_bytes(
            "GET", f"http://{master.url}/dir/lookup?volumeId={vid}")[0] == 200
            and url in http_bytes("GET", f"http://{master.url}/dir/lookup?volumeId={vid}")[1]
            .decode())
        calls = []
        codec = vs.store.ec_codec
        real = codec.reconstruct

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        codec.reconstruct = counted
        try:
            assert _post(url, "/_query", dict(q, fid=target)) == (200, plain)
        finally:
            del codec.reconstruct
        assert calls, "the EC read never reconstructed"
    finally:
        vs.stop()


def test_default_backend_without_a_card_answers_500(tmp_path, master, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vs = _server(PVolumeServer, tmp_path, "dflt", master.url)
    try:
        url = f"127.0.0.1:{vs.port}"
        http_bytes("POST", f"http://{url}/admin/assign_volume?volume=41")
        _put(url, "41,0100000007", _csv(3, 20))
        status, out = _post(url, "/_query", {"fid": "41,0100000007", "input": "csv",
                                             "sql": "SELECT * FROM s3object"})
        assert status == 500 and "no CUDA device" in out["error"] and "cuda" in out["error"]
    finally:
        vs.stop()
