"""The port's master daemon (``seaweedfs_tpu_torch.server.master_server``)
over HTTP, held against the JAX package's.

- The same seeded heartbeats and requests to both masters give the same
  replies: lookup, ``lookup_ec``, the topology in ``/dir/status``, assign
  (fids without their cookie) and the ``/cluster/watch`` feed.
- The heartbeat ack names the master itself as leader; the port's volume
  servers register and stay.
- Assign carries a fid-scoped JWT when a signing key is set.
- ``/vol/vacuum`` compacts a JAX volume server's garbage volume (the port's
  volume server has no vacuum routes yet).
- The reaper drops a dead server, ``/cluster/leave`` drops a live one,
  the admin lock is exclusive, ``/col/delete`` reaches the servers.
- ``stop()`` returns at once: there is no election loop to wait for.
"""

import random
import socket
import threading
import time

import pytest

from seaweedfs_tpu.cluster import volume_layout as j_layout
from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.cluster import volume_layout as p_layout
from seaweedfs_tpu_torch.security import decode_jwt
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


@pytest.fixture
def master():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    yield m
    m.stop()


def _beats():
    """Heartbeats of four servers over two data centers: plain volumes in
    two collections (one hot), EC shards, then deltas."""
    out = []
    for i in range(4):
        hb = {"ip": f"10.0.{i // 2}.{i}", "port": 8080 + i,
              "public_url": f"10.0.{i // 2}.{i}:{8080 + i}",
              "data_center": f"dc{i // 2}", "rack": f"rack{i % 2}",
              "max_volume_count": 8, "max_file_key": 100 * i,
              "volumes": [{"id": 10 + 3 * i + j, "size": 4096 * (j + 1),
                           "collection": "pics" if j < 2 else "docs",
                           "replica_placement": 0, "file_count": j,
                           "read_heat": 40.0 if (i, j) == (1, 0) else 0.0}
                          for j in range(3)],
              "ec_shards": [{"id": 90, "collection": "warm",
                             "ec_index_bits": 0b1111 << (4 * i) & 0x3FFF}]}
        out.append(hb)
    out.append({"ip": "10.0.0.0", "port": 8080,
                "new_volumes": [{"id": 40, "collection": "pics", "replica_placement": 0}],
                "deleted_ec_shards": [{"id": 90, "ec_index_bits": 0b10}]})
    out.append({"ip": "10.0.1.3", "port": 8083,
                "deleted_volumes": [{"id": 20, "collection": "docs", "replica_placement": 0}],
                "new_ec_shards": [{"id": 90, "ec_index_bits": 0b10}]})
    return out


def _drive(url, layout_mod, seed):
    random.seed(seed)
    layout_mod.seed_placement(seed)
    out = [http_json("POST", f"http://{url}/cluster/heartbeat", hb) for hb in _beats()]
    for ack in out:
        ack.pop("leader")
    for vid in (10, 11, 20, 40, 90, 77):
        out.append(http_json("GET", f"http://{url}/dir/lookup?volumeId={vid}"))
        out.append(http_json("GET", f"http://{url}/dir/lookup_ec?volumeId={vid}"))
    for col in ("pics", "docs", "pics", "pics", "docs"):
        a = http_json("GET", f"http://{url}/dir/assign?collection={col}&count=3")
        f = FileId.parse(a.pop("fid"))
        out.append((f.volume_id, f.key, a))
    out.append(http_json("GET", f"http://{url}/dir/status")["topology"])
    out.append(http_json("GET", f"http://{url}/cluster/watch?since=3"))
    out.append(http_json("GET", f"http://{url}/col/list"))
    return out


def test_http_replies_match_the_jax_master():
    jm = JMasterServer(port=free_port(), node_timeout=60).start()
    pm = MasterServer(port=free_port(), node_timeout=60).start()
    try:
        assert _wait(lambda: http_json("GET", f"http://{jm.url}/dir/status")["is_leader"])
        want = _drive(jm.url, j_layout, 5)
        got = _drive(pm.url, p_layout, 5)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (i, g, w)
    finally:
        pm.stop()
        threading.Thread(target=jm.stop, daemon=True).start()


def test_heartbeat_ack_names_the_master_and_servers_stay(master, tmp_path):
    ack = http_json("POST", f"http://{master.url}/cluster/heartbeat",
                    {"ip": "10.9.9.9", "port": 1, "volumes": []})
    assert ack == {"volume_size_limit": 30 << 30, "leader": master.url}
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.2, ec_backend="cpu").start()
    try:
        url = f"127.0.0.1:{vs.port}"
        nodes = lambda: [n["url"] for dc in http_json(
            "GET", f"http://{master.url}/dir/status")["topology"]["data_centers"]
            for r in dc["racks"] for n in r["nodes"]]
        assert _wait(lambda: url in nodes())
        time.sleep(0.6)  # a few beats later it still follows this master
        assert vs.master_url == master.url and url in nodes()
        st = http_json("GET", f"http://{master.url}/dir/status")
        assert set(st) == {"version", "leader", "is_leader", "term", "topology", "locks",
                           "serving", "fleet", "assign", "fid_leases", "lifecycle", "trace"}
        assert st["leader"] == master.url and st["is_leader"] is True
    finally:
        vs.stop()


def test_assign_carries_a_fid_scoped_jwt(tmp_path):
    m = MasterServer(port=free_port(), node_timeout=60, jwt_signing_key="k3y").start()
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=m.url,
                      pulse_seconds=0.2, ec_backend="cpu").start()
    try:
        assert _wait(lambda: m.master.topo.data_nodes())
        a = http_json("POST", f"http://{m.url}/dir/assign")
        claims = decode_jwt("k3y", a["auth"])
        assert claims["fid"] == a["fid"]
        assert decode_jwt("other", a["auth"]) is None
        assert http_json("GET", f"http://{m.url}/dir/status")["assign"]["count"] == 1
    finally:
        vs.stop()
        m.stop()


def test_vacuum_compacts_a_jax_volume_server(master, tmp_path):
    vs = JVolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                       pulse_seconds=0.2, ec_backend="numpy").start()
    try:
        assert _wait(lambda: master.master.topo.data_nodes())
        a = http_json("GET", f"http://{master.url}/dir/assign?count=20")
        first = FileId.parse(a["fid"])
        fids = [str(FileId(first.volume_id, first.key + i, first.cookie)) for i in range(20)]
        for fid in fids:
            assert http_bytes("POST", f"http://{a['url']}/{fid}", b"z" * 20_000)[0] == 201
        for fid in fids[:15]:
            assert http_bytes("DELETE", f"http://{a['url']}/{fid}")[0] == 202
        r = http_json("POST", f"http://{master.url}/vol/vacuum?garbageThreshold=0.3")
        assert r == {"compacted": [first.volume_id]}
        for fid in fids[15:]:
            assert http_bytes("GET", f"http://{a['url']}/{fid}") == (200, b"z" * 20_000)
    finally:
        vs.stop()


def test_reaper_drops_a_dead_server_and_leave_drops_a_live_one(tmp_path):
    m = MasterServer(port=free_port(), node_timeout=1.0).start()
    servers = [VolumeServer([str(tmp_path / f"v{i}")], port=free_port(), master_url=m.url,
                            pulse_seconds=0.2, ec_backend="cpu").start() for i in range(2)]
    urls = [f"127.0.0.1:{s.port}" for s in servers]
    try:
        assert _wait(lambda: len(m.master.topo.data_nodes()) == 2)
        for vid, s in zip((5, 6), servers):
            http_json("POST", f"http://127.0.0.1:{s.port}/admin/assign_volume?volume={vid}")
        assert _wait(lambda: m.master.lookup_volume(5) and m.master.lookup_volume(6))
        servers[0].stop()
        assert _wait(lambda: not m.master.lookup_volume(5), timeout=10)
        assert [dn.url() for dn in m.master.topo.data_nodes()] == [urls[1]]
        assert http_json("POST", f"http://{m.url}/cluster/leave?url={urls[1]}") == {"left": urls[1]}
        assert m.master.lookup_volume(6) == []
        r = http_json("POST", f"http://{m.url}/cluster/leave?url=10.1.1.1:1")
        assert r["_status"] == 404
    finally:
        servers[1].stop()
        m.stop()


def test_admin_lock_and_collection_delete(master, tmp_path):
    r = http_json("POST", f"http://{master.url}/cluster/lock?client=a")
    token = r["token"]
    assert http_json("POST", f"http://{master.url}/cluster/lock?client=b")["_status"] == 409
    http_json("POST", f"http://{master.url}/cluster/unlock?token={token}")
    assert "token" in http_json("POST", f"http://{master.url}/cluster/lock?client=b")

    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.2, ec_backend="cpu").start()
    try:
        assert _wait(lambda: master.master.topo.data_nodes())
        assert http_json("POST", f"http://{master.url}/vol/grow?collection=gone&count=2") == {"count": 2}
        vurl = f"127.0.0.1:{vs.port}"
        assert len(http_json("GET", f"http://{vurl}/status")["volumes"]) == 2
        assert http_json("GET", f"http://{master.url}/col/list") == {"collections": ["gone"]}
        r = http_json("POST", f"http://{master.url}/col/delete?collection=gone")
        assert sorted(r["volumes"]) == [1, 2]
        assert http_json("GET", f"http://{vurl}/status")["volumes"] == []
    finally:
        vs.stop()


def test_stop_is_immediate():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    http_json("POST", f"http://{m.url}/ec/fleet/encode?volumeIds=3")  # starts the workers
    t0 = time.monotonic()
    m.stop()
    assert time.monotonic() - t0 < 3.0
    with pytest.raises(OSError):
        http_json("GET", f"http://{m.url}/cluster/ping", timeout=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_the_reference(seed):
    """The port's Histogram (the assign summary in /dir/status, the fleet's
    job latency) against the JAX package's on the same observations."""
    import numpy as np

    from seaweedfs_tpu.stats.histogram import Histogram as JHistogram
    from seaweedfs_tpu_torch.stats.histogram import Histogram

    rng = np.random.default_rng(seed)
    values = np.exp(rng.uniform(np.log(1e-5), np.log(20.0), 500))
    hs = [Histogram("t_seconds"), JHistogram("t_seconds")]
    for v in values:
        for h, kw in zip(hs, ({}, {"trace_id": ""})):
            h.observe(float(v), op="assign", **kw)
    port, ref = hs
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(q, op="assign") == ref.quantile(q, op="assign")
    assert port.summary(op="assign") == ref.summary(op="assign")
    assert port.count(op="assign") == ref.count(op="assign") == 500
    assert port.summary(op="other") == ref.summary(op="other")
