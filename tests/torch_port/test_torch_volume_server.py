"""The port's volume server in a live cluster, driven by the JAX package's
master and shell, held byte for byte against the reference.

A JAX ``MasterServer`` and three volume servers run on loopback ports: three
port ``VolumeServer``s (``ec_backend="cpu"``), or one JAX volume server and
two port ones, so that shards cross between the two implementations through
``/admin/ec/copy``. The shell runs ``ec.encode``, a 4-shard ``ec.rebuild``
and ``ec.decode`` (as ``tests/test_shell.py`` does). The shard files must
equal the JAX ``NumpyCodec`` encode of the same .dat, every download must
return the uploaded bytes, and the decoded .dat must equal the original.
"""

import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu import operation
from seaweedfs_tpu.ec import encoder as jencoder
from seaweedfs_tpu.ec.codec import NumpyCodec
from seaweedfs_tpu.server.http_util import http_bytes, http_json
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell.commands import CommandEnv
from seaweedfs_tpu.shell.shell import run_command
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId

COLLECTION = "warm"


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
        time.sleep(0.1)
    return cond()


@pytest.fixture(params=["port", "mixed"])
def cluster(request, tmp_path):
    """(master url, shell env, urls of the port servers, work dir)."""
    master = MasterServer(port=free_port(), node_timeout=60).start()
    kinds = ["port"] * 3 if request.param == "port" else ["jax", "port", "port"]
    servers = []
    for i, kind in enumerate(kinds):
        cls, backend = (PVolumeServer, "cpu") if kind == "port" else (JVolumeServer, "numpy")
        servers.append(cls([str(tmp_path / f"srv{i}")], port=free_port(),
                           master_url=master.url, max_volume_count=10,
                           pulse_seconds=0.4, ec_backend=backend).start())
    env = CommandEnv(master.url)
    try:
        assert _wait(lambda: len(env.data_nodes()) == 3)
        ports = {f"127.0.0.1:{s.port}" for s, k in zip(servers, kinds) if k == "port"}
        yield master.url, env, ports, tmp_path
    finally:
        for s in servers:
            s.stop()
        # the master's stop waits ~10 s on its background loops: let it
        # finish beside the next test
        threading.Thread(target=master.stop, daemon=True).start()


def _fill(master_url, port_urls, n_files=60):
    """Upload seeded blobs (40-400 KB) into one volume that a port server
    holds, so the port server generates the shards. One batch assign
    reserves the keys: the master's heat balancing would steer single
    assigns away from the volume being filled. Returns (vid, {fid: bytes})."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        a = operation.assign(master_url, count=n_files, collection=COLLECTION)
        if a.url in port_urls:
            break
    else:
        pytest.fail("no assign landed on a port server")
    first = FileId.parse(a.fid)
    blobs = {}
    for i in range(n_files):
        fid = str(FileId(first.volume_id, first.key + i, first.cookie))
        data = rng.bytes(int(rng.integers(40_000, 400_000)))
        operation.upload_data(a.url, fid, data)
        blobs[fid] = data
    return first.volume_id, blobs


def _file(url, vid, ext):
    status, data = http_bytes(
        "GET", f"http://{url}/admin/file?volume={vid}&collection={COLLECTION}&ext={ext}")
    assert status == 200, (url, ext, status)
    return data


def _downloads_ok(master_url, blobs):
    for fid, want in blobs.items():
        assert operation.download(master_url, fid) == want, fid


def test_shell_ec_encode_rebuild_decode(cluster):
    master_url, env, port_urls, tmp = cluster
    vid, blobs = _fill(master_url, port_urls)
    source = env.volume_locations(vid)[0]
    assert source in port_urls
    _downloads_ok(master_url, blobs)

    # the reference encode of the same .dat, computed apart
    ref = tmp / "ref"
    ref.mkdir()
    base = str(ref / f"{COLLECTION}_{vid}")
    orig_dat = _file(source, vid, ".dat")
    with open(base + ".dat", "wb") as f:
        f.write(orig_dat)
    with open(base + ".idx", "wb") as f:
        f.write(_file(source, vid, ".idx"))
    assert len(orig_dat) > 10 * (1 << 20)  # the small rows span every data shard
    jencoder.write_ec_files(base, NumpyCodec())
    ref_shards = {}
    for sid in range(14):
        with open(base + shard_ext(sid), "rb") as f:
            ref_shards[sid] = f.read()

    res = run_command(env, f"ec.encode -volumeId={vid} -collection={COLLECTION}")
    assert res["volume"] == vid
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 14)
    by_shard = env.ec_shard_locations(vid)
    for sid, urls in by_shard.items():
        assert _file(urls[0], vid, shard_ext(sid)) == ref_shards[sid], sid
    _downloads_ok(master_url, blobs)

    # lose four shards of one server (the RS(10,4) worst case), read through
    # the loss, then rebuild
    holders = sorted({u for urls in by_shard.values() for u in urls})
    assert len(holders) == 3
    victim = holders[0]
    lost = sorted(sid for sid, urls in by_shard.items() if victim in urls)[:4]
    r = http_json("POST", f"http://{victim}/admin/ec/delete_shards?volume={vid}"
                          f"&shards={','.join(map(str, lost))}")
    assert r["removed"] == lost
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 10)
    _downloads_ok(master_url, blobs)

    res = run_command(env, f"ec.rebuild -volumeId={vid} -collection={COLLECTION}")
    assert sorted(res["rebuilt"]) == lost
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 14)
    by_shard = env.ec_shard_locations(vid)
    for sid in lost:
        assert _file(by_shard[sid][0], vid, shard_ext(sid)) == ref_shards[sid], sid
    _downloads_ok(master_url, blobs)

    res = run_command(env, f"ec.decode -volumeId={vid} -collection={COLLECTION}")
    assert res["dat_size"] == len(orig_dat) and res["file_count"] == len(blobs)
    assert "retire_errors" not in res
    assert _file(res["decoded_on"], vid, ".dat") == orig_dat
    assert _wait(lambda: env.ec_shard_locations(vid) == {})
    _downloads_ok(master_url, blobs)
