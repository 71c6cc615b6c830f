"""The source of an ``ec.encode`` keeps its ``.vif``.

``Volume.destroy`` leaves ``<base>.vif`` while an ``.ecx`` of the same base
lies beside it: the EC volume made from the volume owns the file then, and
its scrub checks the shard sums in it. The JAX package's destroy removes
it, so its scrub is blind on that server: a deliberate difference of the
port.

Unit: a destroyed volume with an ``.ecx`` beside it leaves exactly its
``.vif``; without one, nothing. End to end, for each package: a master and
two volume servers, a volume of seeded needles on the first, the shell's
``ec.encode`` (spread over both, the plain volume deleted on the source).
The port's source still holds the ``.vif`` with its 14 shard sums, and a
byte flipped in a shard it holds is reported by ``_scrub_ec_step``; the
JAX package's source has no ``.vif`` and its scrub reports nothing.
"""

import os
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu_torch.ec import encoder
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv, ec_encode
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.volume import Volume

VID = 6
KINDS = {"jax": (JVolumeServer, JNeedle, "numpy"), "port": (PVolumeServer, PNeedle, "cpu")}


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("with_ecx", [True, False])
def test_destroy_keeps_the_vif_beside_an_ecx(tmp_path, with_ecx):
    v = Volume(str(tmp_path), "", VID)
    v.write_needle(PNeedle(cookie=1, id=1, data=b"x" * 100))
    base = v.file_name()
    encoder.save_volume_info(base + ".vif", version=3, replication="000",
                             shard_sums=["0" * 64] * 14)
    if with_ecx:
        open(base + ".ecx", "wb").close()
    v.destroy()
    left = sorted(os.listdir(tmp_path))
    assert left == ([f"{VID}.ecx", f"{VID}.vif"] if with_ecx else [])


def _flip(path, at=777):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _scrub_findings(vs):
    """Every (vid, shard) one pass of the scrub step reports on ``vs``."""
    ev = vs.store.find_ec_volume(VID)
    found = []
    cursor = vs._scrub_ec_step(ev, 0, report=lambda vid, sid: found.append((vid, sid)))
    while cursor:
        cursor = vs._scrub_ec_step(ev, cursor, report=lambda vid, sid: found.append((vid, sid)))
    return found


@pytest.mark.parametrize("kind", list(KINDS))
def test_the_encodes_source_scrubs_its_shards(tmp_path, kind):
    cls, ncls, backend = KINDS[kind]
    master = MasterServer(port=free_port(), node_timeout=60).start()
    servers = [cls([str(tmp_path / f"s{i}")], port=free_port(), master_url=master.url,
                   pulse_seconds=0.3, ec_backend=backend).start() for i in range(2)]
    try:
        src = servers[0]
        v = src.store.add_volume(VID)
        rng = np.random.default_rng(6)
        for i in range(1, 41):
            v.write_needle(ncls(cookie=0x66, id=i, data=rng.bytes(int(rng.integers(1000, 90_000)))))
        v.sync()
        env = CommandEnv(master.url)
        deadline = time.time() + 15
        while time.time() < deadline and not env.volume_locations(VID):
            time.sleep(0.1)
        ec_encode(env, VID)
        base = os.path.join(src.store.locations[0].directory, str(VID))
        assert not os.path.exists(base + ".dat") and os.path.exists(base + ".ecx")
        held = src.store.find_ec_volume(VID).shard_ids()
        assert held
        _flip(base + shard_ext(held[0]))
        found = _scrub_findings(src)
        if kind == "port":
            sums = encoder.load_volume_info(base + ".vif")["shard_sums"]
            assert len(sums) == 14
            assert found == [(VID, held[0])]
        else:
            assert not os.path.exists(base + ".vif")
            assert found == []
    finally:
        for s in servers:
            s.stop()
        master.stop()
