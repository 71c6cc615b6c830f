"""The port volume server's needle data plane against the JAX package's.

The same POSTs (name, mime, ttl, a client-gzipped body, a chunk manifest)
go to a JAX volume server and a port one; the stored needles must carry the
same bytes and flags, and GET, HEAD, Range and gzip negotiation must answer
the same. Then the JAX package's client drives a port server alone: a
chunked file (manifest resolved on the server, ranged reads across chunks,
delete cascading to the chunks) and a batch delete.
"""

import gzip
import http.client
import json
import socket
import threading

import pytest

from seaweedfs_tpu import operation
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.storage.volume import Volume

VID = 5
BODY = bytes(range(256)) * 40
CASES = {
    "plain": ("01000000a1", BODY, {}, ""),
    "named": ("02000000a2", BODY[:999], {"X-Sweed-Name": "a.txt", "X-Sweed-Mime": "text/plain"}, ""),
    "ttl": ("03000000a3", BODY[:77], {}, "?ttl=3d"),
    "gzip": ("04000000a4", gzip.compress(BODY, mtime=0), {"Content-Encoding": "gzip"}, ""),
    "manifest": ("05000000a5", b'{"size": 0, "chunks": []}', {"X-Sweed-Chunk-Manifest": "true"}, ""),
}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster(cls, directory, backend):
    master = MasterServer(port=free_port(), node_timeout=60).start()
    vs = cls([directory], port=free_port(), master_url=master.url, pulse_seconds=0.5,
             ec_backend=backend).start()
    return master, vs, f"127.0.0.1:{vs.port}"


def _teardown(master, vs):
    vs.stop()
    threading.Thread(target=master.stop, daemon=True).start()  # its stop takes ~10 s


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{"jax": url, "port": url}: one volume server of each kind, each with
    its own master, each holding volume VID with the CASES uploaded."""
    made, urls = [], {}
    for name, cls, backend in (("jax", JVolumeServer, "numpy"), ("port", PVolumeServer, "cpu")):
        d = str(tmp_path_factory.mktemp(name))
        master, vs, url = _cluster(cls, d, backend)
        made.append((master, vs))
        urls[name] = (url, d)
        assert http_bytes("POST", f"http://{url}/admin/assign_volume?volume={VID}")[0] == 200
        for key, body, headers, query in CASES.values():
            status, _ = http_bytes("POST", f"http://{url}/{VID},{key}{query}", body,
                                   headers=headers)
            assert status == 201, (name, key)
    yield urls
    for master, vs in made:
        _teardown(master, vs)


def _stored(directory):
    """{needle id: the fields a POST sets} from the volume's .dat."""
    v = Volume(directory, "", VID, create_if_missing=False)
    try:
        return {n.id: (n.cookie, n.data, n.flags, n.name, n.mime, bytes(n.ttl.to_bytes()))
                for n, _, _ in v.scan_needles(verify_crc=True)}
    finally:
        v.close()


def test_posts_are_stored_as_the_reference_stores_them(pair):
    port, jax = _stored(pair["port"][1]), _stored(pair["jax"][1])
    assert port == jax and len(port) == len(CASES)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method,headers", [
    ("GET", {}), ("GET", {"Accept-Encoding": "gzip"}), ("GET", {"Range": "bytes=2-9"}),
    ("GET", {"Range": "bytes=-5"}), ("GET", {"Range": "bytes=99999-"}), ("HEAD", {}),
])
def test_reads_answer_as_the_reference(pair, case, method, headers):
    key = CASES[case][0]
    answers = {}
    for name, (url, _) in pair.items():
        conn = http.client.HTTPConnection(url, timeout=10)
        try:
            conn.request(method, f"/{VID},{key}", headers=headers)
            r = conn.getresponse()
            answers[name] = (r.status, r.read(), r.getheader("Content-Encoding"),
                             r.getheader("Content-Range"), r.getheader("Content-Length"))
        finally:
            conn.close()
    assert answers["port"] == answers["jax"]


@pytest.fixture(scope="module")
def port_alone(tmp_path_factory):
    master, vs, url = _cluster(PVolumeServer, str(tmp_path_factory.mktemp("alone")), "cpu")
    yield master.url, url
    _teardown(master, vs)


def test_chunked_file_through_the_reference_client(port_alone):
    master, url = port_alone
    data = bytes((i * 7) % 251 for i in range(2_600_000))
    fid = operation.submit(master, data, name="big.bin", max_mb=1)
    assert operation.download(master, fid) == data
    status, body = http_bytes("GET", f"http://{url}/{fid}", headers={"Range": "bytes=1048000-1049999"})
    assert (status, body) == (206, data[1048000:1050000])
    status, raw = http_bytes("GET", f"http://{url}/{fid}?cm=false")
    chunks = [c["fid"] for c in json.loads(raw)["chunks"]]
    assert status == 200 and len(chunks) == 3
    assert operation.delete_file(master, fid)
    for f in [fid] + chunks:
        assert http_bytes("GET", f"http://{url}/{f}")[0] == 404, f


def test_batch_delete_through_the_reference_client(port_alone):
    master, url = port_alone
    fids = [operation.submit(master, f"blob {i}".encode() * 100) for i in range(6)]
    manifest = operation.submit(master, b"m" * 1_500_000, max_mb=1)
    assert operation.delete_files(master, fids[:4] + [manifest, "bad-fid"]) == 5
    for f in fids[:4] + [manifest]:
        assert http_bytes("GET", f"http://{url}/{f}")[0] == 404, f
    for f in fids[4:]:
        assert operation.download(master, f).startswith(b"blob")
