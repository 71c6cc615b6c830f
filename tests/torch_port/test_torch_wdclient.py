"""``wdclient.py`` of the port held against the JAX package's, over a port
master.

``VidMap`` gives the same answers for the same adds, deletes and
snapshots. A port ``MasterClient`` and a JAX one, both started on one port
master's ``/cluster/watch`` feed, learn the same volume locations as
volumes grow, and both drop a volume when ``ec.encode`` deletes it; a
client that was never started answers a lookup through ``/dir/lookup``
(the EC shard holders for an EC'd volume) and caches the answer.
"""

import socket
import time

import pytest

from seaweedfs_tpu import wdclient as jwd
from seaweedfs_tpu_torch import operation
from seaweedfs_tpu_torch import wdclient as pwd
from seaweedfs_tpu_torch.server.http_util import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wd")
    master = MasterServer(port=free_port(), node_timeout=30).start()
    vss = [VolumeServer([str(tmp / f"v{i}")], port=free_port(), master_url=master.url,
                        max_volume_count=10, pulse_seconds=0.5, ec_backend="cpu").start()
           for i in range(2)]
    assert _until(lambda: len(master.master.topo.data_nodes()) == 2)
    yield master, vss
    for vs in vss:
        vs.stop()
    master.stop()


def _vm_trace(mod):
    vm = mod.VidMap()
    out = []
    vm.add_location(3, mod.Location("a:1"))
    vm.add_location(3, mod.Location("b:2", "pub:2"))
    vm.add_location(3, mod.Location("a:1"))  # dedup
    out.append([(x.url, x.public_url) for x in vm.lookup_volume(3)])
    vm.delete_location(3, "a:1")
    out.append([x.url for x in vm.lookup_volume(3)])
    vm.delete_location(3, "b:2")
    out.append(vm.lookup_volume(3))
    vm.replace_all({"7": [{"url": "c:3", "public_url": "c:3"}], 8: [{"url": "d:4"}]})
    out.append((vm.lookup_volume_url(7), vm.lookup_volume_url(9), len(vm)))
    vm.invalidate(7)
    out.append((vm.lookup_volume(7), len(vm)))
    return out


def test_vid_map_equal():
    assert _vm_trace(jwd) == _vm_trace(pwd)
    assert pwd.Location("x:1") == pwd.Location("x:1", "other")


def _snapshot(mc) -> dict:
    with mc.vid_map._lock:
        return {vid: sorted(l.url for l in locs) for vid, locs in mc.vid_map._locations.items()}


def test_watch_feeds_equal_through_growth_and_ec(cluster):
    master, vss = cluster
    clients = {"jax": jwd.MasterClient(master.url, "t-jax").start(),
               "port": pwd.MasterClient(master.url, "t-port").start()}
    try:
        a = operation.assign(master.url, collection="wd")
        operation.upload_data(a.url, a.fid, b"hello wdclient")
        vid = int(a.fid.split(",")[0])
        for mc in clients.values():
            assert _until(lambda mc=mc: mc.vid_map.lookup_volume(vid)), "never learnt"
        assert _until(lambda: _snapshot(clients["jax"]) == _snapshot(clients["port"]))
        assert clients["port"].lookup_file_id(a.fid) == [f"http://{a.url}/{a.fid}"]
        assert clients["port"].current_master == master.url
        run_command(CommandEnv(master.url), f"ec.encode -volumeId={vid} -collection=wd")
        for mc in clients.values():  # the plain volume is gone from the feed
            assert _until(lambda mc=mc: not mc.vid_map.lookup_volume(vid)), "kept the volume"
        assert _snapshot(clients["jax"]) == _snapshot(clients["port"])
        # a lookup on the miss asks the master, which names the shard holders
        holders = {u for urls in CommandEnv(master.url).ec_shard_locations(vid).values()
                   for u in urls}
        got = {k: sorted(l.url for l in mc.lookup_volume(vid)) for k, mc in clients.items()}
        assert got["jax"] == got["port"] == sorted(holders)
    finally:
        for mc in clients.values():
            mc.stop()


def test_snapshot_resync_when_behind(cluster):
    master, _ = cluster
    operation.assign(master.url)
    r = http_json("GET", f"http://{master.url}/cluster/watch?since=-1&timeout=0")
    assert "snapshot" in r or r["events"]
    j, p = jwd.MasterClient(master.url, "j"), pwd.MasterClient(master.url, "p")
    j._apply(r)
    p._apply(r)
    assert len(p.vid_map) > 0 and _snapshot(j) == _snapshot(p)
    assert p._version == j._version == r["version"]


def test_lookup_miss_falls_back_to_master(cluster):
    master, _ = cluster
    a = operation.assign(master.url)
    operation.upload_data(a.url, a.fid, b"miss path")
    mc = pwd.MasterClient([master.url], "t-miss")  # never started: a cold cache
    assert mc.lookup_file_id(a.fid) == [f"http://{a.url}/{a.fid}"]
    assert mc.vid_map.lookup_volume(int(a.fid.split(",")[0]))
    assert pwd.MasterClient(["127.0.0.1:1"], "t-dead").lookup_volume(1) == []
    assert pwd.find_reachable_master(["127.0.0.1:1", master.url]) == master.url
