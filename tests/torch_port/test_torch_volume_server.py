"""The port's volume server in a live cluster, driven by the JAX package's
master and shell and by the port's own, held byte for byte against the
reference.

A master and three volume servers run on loopback ports: three port
``VolumeServer``s (``ec_backend="cpu"``), or one JAX volume server and two
port ones, so that shards cross between the two implementations through
``/admin/ec/copy``. The master and the shell are each the JAX package's or
the port's: (JAX master, JAX shell) over both server mixes, then (port,
port), (JAX shell -> port master) and (port shell -> JAX master) over three
port servers, and (port, port) over the mixed servers. The shell runs
``ec.encode``, a 4-shard ``ec.rebuild`` and ``ec.decode`` (as
``tests/test_shell.py`` does). The shard files must equal the JAX
``NumpyCodec`` encode of the same .dat, every download must return the
uploaded bytes, and the decoded .dat must equal the original.

The scenario is seeded: the servers' ports rise with their index (so a
server's rank in URL order is its index), the needles are the same bytes
under the same fids, and the port servers stamp them with a fixed time. So
every pairing must give what (JAX master, JAX shell) gives on the same
servers: the shard layout by server rank, the shard sha256s, the rebuilder's
rank and the rebuilt shards, the decode target's rank, ``dat_size`` and
``file_count``.
"""

import contextlib
import hashlib
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
from seaweedfs_tpu_torch.server import volume_server as p_volume_server
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv as PCommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command as p_run_command
from seaweedfs_tpu_torch.storage import volume as p_volume
from seaweedfs_tpu_torch.storage.file_id import FileId

COLLECTION = "warm"
SOURCE_RANK = 1  # the server that holds the plain volume: a port server in both mixes
SOURCE_VID = 11  # the plain volume, allocated on the source
NOW = 1_760_000_000  # the needles' fixed time stamp, seconds

# pairing id -> (master, shell, server mix); "port" and "mixed" are
# (JAX master, JAX shell), the reference of each mix
PAIRINGS = {
    "port": ("jax", "jax", "port"),
    "mixed": ("jax", "jax", "mixed"),
    "portmaster-portshell": ("port", "port", "port"),
    "portmaster-jaxshell": ("port", "jax", "port"),
    "jaxmaster-portshell": ("jax", "port", "port"),
    "portmaster-portshell-mixed": ("port", "port", "mixed"),
}
_REFERENCE: dict = {}  # server mix -> the (JAX, JAX) scenario's summary


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


def _rising_ports(n):
    """n free ports in rising order, with the same number of digits, so that
    sorting the servers' URLs sorts them by index."""
    while True:
        ports = sorted(free_port() for _ in range(n))
        if len({len(str(p)) for p in ports}) == 1:
            return ports


class _FrozenTime:
    """The ``time`` module with ``time``/``time_ns`` fixed at ``NOW``."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(NOW)

    @staticmethod
    def time_ns():
        return NOW * 1_000_000_000


@contextlib.contextmanager
def _cluster(master_kind, shell_kind, mix, tmp_path):
    """Yield (master url, shell run_command, shell env, port server urls,
    urls by rank); stops every daemon on exit."""
    cls = PMasterServer if master_kind == "port" else MasterServer
    master = cls(port=free_port(), node_timeout=60).start()
    kinds = ["port"] * 3 if mix == "port" else ["jax", "port", "port"]
    servers = []
    try:
        for i, (kind, port) in enumerate(zip(kinds, _rising_ports(3))):
            vcls, backend = (PVolumeServer, "cpu") if kind == "port" else (JVolumeServer, "numpy")
            servers.append(vcls([str(tmp_path / f"srv{i}")], port=port,
                                master_url=master.url, max_volume_count=10,
                                pulse_seconds=0.4, ec_backend=backend).start())
        env = (PCommandEnv if shell_kind == "port" else CommandEnv)(master.url)
        run = p_run_command if shell_kind == "port" else run_command
        assert _wait(lambda: len(env.data_nodes()) == 3)
        urls = [f"127.0.0.1:{s.port}" for s in servers]
        assert sorted(urls) == urls
        ports = {u for u, k in zip(urls, kinds) if k == "port"}
        yield master.url, run, env, ports, urls
    finally:
        for s in servers:
            s.stop()
        if master_kind == "port":
            master.stop()  # the port's master has no election loop to wait for
        else:
            # the JAX master's stop waits ~10 s on its background loops:
            # let it finish beside the next test
            threading.Thread(target=master.stop, daemon=True).start()


@pytest.fixture
def frozen_needle_time(monkeypatch):
    monkeypatch.setattr(p_volume, "time", _FrozenTime())
    monkeypatch.setattr(p_volume_server, "time", _FrozenTime())
    # the native engine stamps its needles with the real clock: the port
    # servers write through Python here, so the shard bytes are the same in
    # every run
    monkeypatch.setenv("SWEED_TURBO", "0")


@pytest.fixture(params=list(PAIRINGS))
def cluster(request, tmp_path, frozen_needle_time):
    """(pairing, master url, shell run_command, shell env, urls of the port
    servers, urls by rank, work dir)."""
    master_kind, shell_kind, mix = PAIRINGS[request.param]
    with _cluster(master_kind, shell_kind, mix, tmp_path) as c:
        yield (request.param, *c, tmp_path)


def _fill(master_url, source, env, n_files=60):
    """Upload seeded blobs (40-400 KB) into one volume that ``source`` (a
    port server) holds, so that a port server generates the shards. The
    volume is allocated on ``source`` itself (the master's growth places a
    collection's first volumes at random, and may leave ``source`` none) and
    announced by its heartbeat; the fids are made here, so every run writes
    the same needles. Returns (vid, {fid: bytes})."""
    rng = np.random.default_rng(11)
    vid = SOURCE_VID
    status, body = http_bytes("POST", f"http://{source}/admin/assign_volume?volume={vid}"
                                      f"&collection={COLLECTION}&replication=000")
    assert status == 200, body
    assert _wait(lambda: env.volume_locations(vid) == [source])
    blobs = {}
    for i in range(n_files):
        fid = str(FileId(vid, 1000 + i, 0x5EED0000 + i))
        data = rng.bytes(int(rng.integers(40_000, 400_000)))
        operation.upload_data(source, fid, data)
        blobs[fid] = data
    return vid, blobs


def _file(url, vid, ext):
    status, data = http_bytes(
        "GET", f"http://{url}/admin/file?volume={vid}&collection={COLLECTION}&ext={ext}")
    assert status == 200, (url, ext, status)
    return data


def _downloads_ok(master_url, blobs):
    for fid, want in blobs.items():
        assert operation.download(master_url, fid) == want, fid


def _scenario(master_url, run, env, port_urls, urls, tmp):
    """encode, lose 4 shards, rebuild, decode; the shard bytes held against
    the JAX NumpyCodec encode and every needle read back at each step.
    Returns the run's summary by server rank."""
    rank = {u: i for i, u in enumerate(urls)}
    source = urls[SOURCE_RANK]
    assert source in port_urls
    vid, blobs = _fill(master_url, source, env)
    assert env.volume_locations(vid) == [source]
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

    res = run(env, f"ec.encode -volumeId={vid} -collection={COLLECTION}")
    assert res["volume"] == vid
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 14)
    by_shard = env.ec_shard_locations(vid)
    for sid, urls_ in by_shard.items():
        assert _file(urls_[0], vid, shard_ext(sid)) == ref_shards[sid], sid
    _downloads_ok(master_url, blobs)
    layout = {r: sorted(sid for sid, us in by_shard.items() if urls[r] in us)
              for r in range(3)}

    # lose four shards of one server (the RS(10,4) worst case), read through
    # the loss, then rebuild
    holders = sorted({u for urls_ in by_shard.values() for u in urls_})
    assert holders == urls
    victim = holders[0]
    lost = sorted(sid for sid, urls_ in by_shard.items() if victim in urls_)[:4]
    r = http_json("POST", f"http://{victim}/admin/ec/delete_shards?volume={vid}"
                          f"&shards={','.join(map(str, lost))}")
    assert r["removed"] == lost
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 10)
    _downloads_ok(master_url, blobs)

    reb = run(env, f"ec.rebuild -volumeId={vid} -collection={COLLECTION}")
    assert sorted(reb["rebuilt"]) == lost
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == 14)
    by_shard = env.ec_shard_locations(vid)
    for sid in lost:
        assert _file(by_shard[sid][0], vid, shard_ext(sid)) == ref_shards[sid], sid
    _downloads_ok(master_url, blobs)

    dec = run(env, f"ec.decode -volumeId={vid} -collection={COLLECTION}")
    assert dec["dat_size"] == len(orig_dat) and dec["file_count"] == len(blobs)
    assert "retire_errors" not in dec
    assert _file(dec["decoded_on"], vid, ".dat") == orig_dat
    assert _wait(lambda: env.ec_shard_locations(vid) == {})
    _downloads_ok(master_url, blobs)
    return {
        "layout_by_rank": layout,
        "shard_sha256": {sid: hashlib.sha256(b).hexdigest() for sid, b in ref_shards.items()},
        "rebuilder_rank": rank[reb["rebuilder"]],
        "rebuilt": sorted(reb["rebuilt"]),
        "decode_rank": rank[dec["decoded_on"]],
        "dat_size": dec["dat_size"],
        "file_count": dec["file_count"],
    }


def _reference(mix, tmp_path):
    """The (JAX master, JAX shell) summary on this server mix, run once."""
    if mix not in _REFERENCE:
        work = tmp_path / f"reference-{mix}"
        work.mkdir()
        with _cluster("jax", "jax", mix, work) as c:
            _REFERENCE[mix] = _scenario(*c, work)
    return _REFERENCE[mix]


def test_shell_ec_encode_rebuild_decode(cluster):
    pairing, master_url, run, env, port_urls, urls, tmp = cluster
    got = _scenario(master_url, run, env, port_urls, urls, tmp)
    master_kind, shell_kind, mix = PAIRINGS[pairing]
    if (master_kind, shell_kind) == ("jax", "jax"):
        _REFERENCE.setdefault(mix, got)
    assert got == _reference(mix, tmp)
    # the round-robin spread from the source, by rank: source first
    assert got["layout_by_rank"] == {1: [0, 3, 6, 9, 12], 0: [1, 4, 7, 10, 13],
                                     2: [2, 5, 8, 11]}
