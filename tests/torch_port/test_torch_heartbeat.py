"""The port volume server's heartbeat loop against the JAX package's master:
a dead first seed is rotated past, and a new volume reaches the master by
an instant delta beat, long before the next full beat is due."""

import socket
import threading
import time

from seaweedfs_tpu import operation
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.shell.commands import CommandEnv
from seaweedfs_tpu_torch.server.http_util import http_json
from seaweedfs_tpu_torch.server.volume_server import VolumeServer


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(cond, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_rotates_past_a_dead_seed_and_sends_delta_beats(tmp_path):
    master = MasterServer(port=free_port(), node_timeout=60).start()
    dead = f"127.0.0.1:{free_port()}"
    vs = VolumeServer([str(tmp_path)], port=free_port(), master_url=f"{dead},{master.url}",
                      pulse_seconds=30.0, ec_backend="cpu").start()
    url = f"127.0.0.1:{vs.port}"
    env = CommandEnv(master.url)
    try:
        assert _wait(lambda: [n["url"] for n in env.data_nodes()] == [url], 10)
        assert vs.master_url == master.url
        # the full beat is 30 s away: only a delta beat can carry this
        http_json("POST", f"http://{url}/admin/assign_volume?volume=9&collection=hb")
        t0 = time.time()
        assert _wait(lambda: env.volume_locations(9) == [url], 5)
        assert time.time() - t0 < 5
        fid = operation.assign(master.url, collection="hb").fid
        assert fid.startswith("9,")
    finally:
        vs.stop()
        threading.Thread(target=master.stop, daemon=True).start()  # its stop takes ~10 s
