"""The port's native CRC-32C library is built when a volume server starts,
outside every volume's lock.

``crc.build`` is wrapped to record, each time it runs, the port volumes
whose ``Volume._lock`` some thread holds. With the library forgotten
(``crc._impl`` reset), a port volume server starts and takes a needle
through its Python write path: the build must have run, with no volume's
lock held, and the needle must read back with the native CRC.
"""

import gc
import socket
import threading

import numpy as np

from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import crc as pcrc
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.volume import Volume


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _locked(lock) -> bool:
    """Whether any thread holds ``lock`` (a ``threading.RLock``)."""
    return repr(lock).startswith("<locked")


def test_crc_is_built_at_server_start_outside_volume_locks(tmp_path, monkeypatch):
    monkeypatch.setenv("SWEED_TURBO", "0")  # the Python write path
    monkeypatch.setattr(pcrc, "_impl", None)
    monkeypatch.setattr(pcrc, "_native", None)
    monkeypatch.setattr(pcrc, "_build_thread", None)
    runs = []
    real_build = pcrc.build

    def recording_build():
        held = [v.id for v in gc.get_objects() if type(v) is Volume and _locked(v._lock)]
        runs.append((threading.current_thread().name, held))
        return real_build()

    monkeypatch.setattr(pcrc, "build", recording_build)
    master = MasterServer(port=_free_port(), node_timeout=60).start()
    vs = VolumeServer([str(tmp_path / "v")], port=_free_port(), master_url=master.url,
                      pulse_seconds=0.3, ec_backend="cpu")
    try:
        assert len(runs) == 1  # the Store built it, before any volume was opened
        vs.start()
        url = f"127.0.0.1:{vs.port}"
        assert http_bytes("POST", f"http://{url}/admin/assign_volume?volume=3"
                                  "&replication=000")[0] == 200
        data = np.random.default_rng(3).bytes(70_000)
        fid = str(FileId(3, 1, 0x1234))
        assert http_bytes("POST", f"http://{url}/{fid}", data)[0] == 201
        assert http_bytes("GET", f"http://{url}/{fid}") == (200, data)
    finally:
        vs.stop()
        master.stop()
    assert runs == [(threading.current_thread().name, [])]
    assert pcrc.implementation() == "native"
