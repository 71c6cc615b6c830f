"""The port's background scrub against the JAX package's.

The same volume (seeded needles, fixed append times) and the same EC set
(the port's cpu codec encodes; the shards equal the reference's, as
``test_torch_store.py`` holds) lie in two directories; one payload byte of
one needle and one byte of one shard are flipped in both. The steps of both
packages' scrub (``_scrub_volume_step``, ``_scrub_ec_step``) then run over
them round after round: the cursor sequences, the reported ``(vid, needle
id)`` and ``(vid, shard id)`` and the deltas of the scrub counters must be
equal. An EC set whose .vif carries no shard sums has nothing to verify.
End to end, a volume server of either package started with ``SWEED_SCRUB=1``
beside the port's master must make the master see the same findings: the
corrupt needle count of the volume and the corrupt shard of the EC volume
on that node. Exact equality; there is no tolerance.
"""

import json
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec.ec_volume import EcVolume as JEcVolume
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.stats import SCRUB_COUNTERS as J_SCRUB_COUNTERS
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu_torch.ec.codec import get_codec
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume as PEcVolume
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.stats.metrics import SCRUB_COUNTERS as P_SCRUB_COUNTERS
from seaweedfs_tpu_torch.storage import store as pstore
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.volume import Volume as PVolume

VID, EC_VID = 4, 5
T0 = 1_700_000_000_000_000_000
BAD_NEEDLE, BAD_SHARD = 17, 6

SCRUB = {
    "jax": (JVolume, JEcVolume, JVolumeServer, J_SCRUB_COUNTERS),
    "port": (PVolume, PEcVolume, PVolumeServer, P_SCRUB_COUNTERS),
}


def _write(v, nmod, n=60, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        v.write_needle(nmod(cookie=0x51 + i, id=i, data=rng.bytes(int(rng.integers(10, 300_000)))),
                       append_at_ns=T0 + i)
    for i in range(3, n, 11):
        v.delete_needle(nmod(cookie=0x51 + i, id=i), append_at_ns=T0 + 1000 + i)
    v.sync()


def _flip_needle_byte(v, nid):
    """Flip one payload byte of needle ``nid`` in the .dat on disk."""
    nv = v.nm.get(nid)
    path = v.file_name() + ".dat"
    with open(path, "r+b") as f:
        f.seek(nv.offset + 16 + 4 + 3)  # header, data size, 3 bytes in
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x5A]))


def _flip_shard_byte(base, sid, at=1234):
    with open(base + shard_ext(sid), "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _stats(counters):
    return {k: c.total() for k, c in counters.items()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.fixture
def dirs(tmp_path):
    """Two directories holding the same volume VID (one needle flipped) and
    the same EC set EC_VID (one shard flipped)."""
    src = tmp_path / "port"
    src.mkdir()
    v = PVolume(str(src), "", VID)
    _write(v, PNeedle)
    _flip_needle_byte(v, BAD_NEEDLE)
    v.close()
    ev = PVolume(str(src), "", EC_VID)
    _write(ev, PNeedle, n=40, seed=4)
    ev.close()
    pstore.ec_encode_volume(os.path.join(str(src), str(EC_VID)), get_codec(device="cpu"),
                            version=3, replication="000")
    _flip_shard_byte(os.path.join(str(src), str(EC_VID)), BAD_SHARD)
    shutil.copytree(src, tmp_path / "jax")
    return {"port": str(src), "jax": str(tmp_path / "jax")}


@pytest.mark.parametrize("budget", [1, 7, 1000])
def test_volume_step_finds_the_same_needle(dirs, budget):
    res = {}
    for pkg, (vcls, _, vs, counters) in SCRUB.items():
        v = vcls(dirs[pkg], "", VID, create_if_missing=False)
        found, cursors = [], []
        before = _stats(counters)
        cursor = 0
        for _ in range(200):
            cursor = vs._scrub_volume_step(v, cursor, budget,
                                           report=lambda vid, nid: found.append((vid, nid)))
            cursors.append(cursor)
            if cursor == 0:
                break
        res[pkg] = (cursors, found, _delta(before, _stats(counters)))
        v.close()
    assert res["port"] == res["jax"]
    cursors, found, delta = res["port"]
    assert cursors[-1] == 0 and found == [(VID, BAD_NEEDLE)]
    assert delta["errors"] == 1 and delta["rounds"] == 1


def test_ec_step_finds_the_same_shard(dirs):
    res = {}
    for pkg, (_, ecls, vs, counters) in SCRUB.items():
        ev = ecls(dirs[pkg], "", EC_VID)
        found, cursors = [], []
        before = _stats(counters)
        cursor = 0
        for _ in range(30):
            cursor = vs._scrub_ec_step(ev, cursor,
                                       report=lambda vid, sid: found.append((vid, sid)))
            cursors.append(cursor)
            if cursor == 0:
                break
        res[pkg] = (cursors, found, _delta(before, _stats(counters)))
        ev.close()
    assert res["port"] == res["jax"]
    cursors, found, delta = res["port"]
    assert cursors == list(range(1, 14)) + [0]
    assert found == [(EC_VID, BAD_SHARD)] and delta["checked"] == 14 and delta["errors"] == 1


def test_ec_step_without_shard_sums_checks_nothing(dirs):
    res = {}
    for pkg, (_, ecls, vs, counters) in SCRUB.items():
        vif = os.path.join(dirs[pkg], f"{EC_VID}.vif")
        with open(vif) as f:
            info = json.load(f)
        info.pop("shard_sums")
        with open(vif, "w") as f:
            json.dump(info, f)
        ev = ecls(dirs[pkg], "", EC_VID)
        found = []
        before = _stats(counters)
        cursor = vs._scrub_ec_step(ev, 5, report=lambda vid, sid: found.append(sid))
        res[pkg] = (cursor, found, _delta(before, _stats(counters)))
        ev.close()
    assert res["port"] == res["jax"] == (0, [], {"checked": 0, "bytes": 0, "errors": 0,
                                                  "rounds": 0})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


@pytest.fixture
def scrub_env(monkeypatch):
    monkeypatch.setenv("SWEED_SCRUB", "1")
    monkeypatch.setenv("SWEED_SCRUB_RATE", "1000")


def test_scrub_findings_reach_the_master(dirs, scrub_env):
    """A server of each package over its directory, under the port's master:
    the master's topology must show the flipped needle's volume with one
    corrupt needle and the EC volume with the flipped shard, alike."""
    seen = {}
    for pkg in ("jax", "port"):
        master = PMasterServer(port=_free_port(), node_timeout=60).start()
        backend = "cpu" if pkg == "port" else "numpy"
        srv = SCRUB[pkg][2]([dirs[pkg]], port=_free_port(), master_url=master.url,
                            pulse_seconds=0.3, ec_backend=backend).start()
        try:
            def node():
                nodes = master.master.topo.data_nodes()
                return nodes[0] if nodes else None

            assert _wait(lambda: node() is not None and VID in node().volumes)
            assert _wait(lambda: node().volumes[VID].corrupt_needles >= 1
                         and node().ec_corrupt.get(EC_VID))
            dn = node()
            seen[pkg] = (dn.volumes[VID].corrupt_needles, dict(dn.ec_corrupt),
                         sorted(srv.store.corrupt_needles.get(VID, ())))
            status = json.loads(_status(srv))
            assert status["scrub"]["crc_errors"] >= 1
        finally:
            srv.stop()
            master.stop()
    assert seen["port"] == seen["jax"] == (1, {EC_VID: [BAD_SHARD]}, [BAD_NEEDLE])


def _status(srv):
    from seaweedfs_tpu_torch.server.http_util import http_bytes

    status, body = http_bytes("GET", f"http://127.0.0.1:{srv.port}/status")
    assert status == 200
    return body


def test_stop_joins_the_scrub_thread(tmp_path, scrub_env):
    master = PMasterServer(port=_free_port(), node_timeout=60).start()
    srv = PVolumeServer([str(tmp_path)], port=_free_port(), master_url=master.url,
                        pulse_seconds=0.3, ec_backend="cpu").start()
    try:
        thread = srv._scrub_thread
        assert thread is not None and thread.is_alive()
    finally:
        srv.stop()
        master.stop()
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert not [t for t in threading.enumerate() if t.name == f"scrub-{srv.port}"]
