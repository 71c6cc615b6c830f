"""Heat from the native engine: needle reads and writes that the engine
answers on the volume server's public port reach the volume's
``read_heat``/``write_heat``, as those the Python daemon answers do.

The yardstick is the same traffic on a volume server with ``SWEED_TURBO=0``
(the daemon serves every request and marks the heat itself): 40 POSTs, 60
GETs and 10 HEADs of needles above the sendfile floor, then 8 DELETEs
(each reads the needle first, so it counts a read and a write). The
volume's counters get a half-life of 10^12 s, so the values are counts;
``collect_heartbeat()`` and ``/status`` must give the same read and write
heat with the engine on as with it off. The JAX package's engine marks no
heat: this is a deliberate difference of the port.

The engine's counts carry over a new registration of the volume: after it
is detached and attached again (as a compaction does) the heat keeps
growing with the traffic. Reading the heartbeat twice adds nothing.
"""

import os
import socket
import time

import pytest

from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

VID = 3
SIZE = 300_000  # above the sendfile floor: the daemon marks each GET once


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fid(key):
    return f"{VID},{key:x}0000abcd"


def _traffic(url, keys=range(1, 41), seed=0):
    for k in keys:
        assert http_bytes("POST", f"{url}/{fid(k)}", bytes([(k + seed) % 256]) * SIZE)[0] == 201
    keys = list(keys)
    for i in range(60):
        assert http_bytes("GET", f"{url}/{fid(keys[i % len(keys)])}")[0] == 200
    for k in keys[:10]:
        assert http_bytes("HEAD", f"{url}/{fid(k)}")[0] == 200
    for k in keys[-8:]:
        assert http_bytes("DELETE", f"{url}/{fid(k)}")[0] == 202


def _heat(vs):
    msg = next(m for m in vs.store.collect_heartbeat()["volumes"] if m["id"] == VID)
    return msg["read_heat"], msg["write_heat"]


@pytest.fixture
def master():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    yield m
    m.stop()


def _server(tmp_path, master, monkeypatch, engine):
    if engine:
        monkeypatch.delenv("SWEED_TURBO", raising=False)
    else:
        monkeypatch.setenv("SWEED_TURBO", "0")
    vs = VolumeServer([str(tmp_path / ("on" if engine else "off"))], port=free_port(),
                      master_url=master.url, ec_backend="cpu", pulse_seconds=0.5).start()
    assert (vs.turbo is not None) == engine
    v = vs.store.add_volume(VID)
    v.read_heat.halflife = v.write_heat.halflife = 1e12
    return vs


def test_engine_heat_equals_the_daemons(tmp_path, master, monkeypatch):
    seen = {}
    for engine in (False, True):
        vs = _server(tmp_path, master, monkeypatch, engine)
        try:
            url = f"http://127.0.0.1:{vs.port}"
            _traffic(url)
            seen[engine] = _heat(vs)
            status = http_json("GET", f"{url}/status")
            got = next(m for m in status["volumes"] if m["id"] == VID)
            assert (got["read_heat"], got["write_heat"]) == seen[engine]
            if engine:
                c = vs.turbo.counters()
                # the engine answered the traffic itself
                assert c["gets"] >= 70 and c["posts"] >= 40 and c["deletes"] >= 8
                assert _heat(vs) == seen[engine]  # a second read adds nothing
        finally:
            vs.stop()
    assert seen[False] == (78.0, 48.0)
    assert seen[True] == seen[False]


def test_heat_survives_a_new_registration(tmp_path, master, monkeypatch):
    vs = _server(tmp_path, master, monkeypatch, True)
    try:
        url = f"http://127.0.0.1:{vs.port}"
        _traffic(url)
        assert _heat(vs) == (78.0, 48.0)
        v = vs.store.find_volume(VID)
        v.detach_turbo()
        vs.store.attach_turbo_volume(v)
        assert v.turbo is not None
        _traffic(url, keys=range(101, 141), seed=1)
        assert _heat(vs) == (156.0, 96.0)
    finally:
        vs.stop()


def test_small_needles_count_once_a_request(tmp_path, master, monkeypatch):
    """Below the sendfile floor the daemon marks a GET more than once; the
    engine counts each request once."""
    vs = _server(tmp_path, master, monkeypatch, True)
    try:
        url = f"http://127.0.0.1:{vs.port}"
        for k in range(1, 21):
            assert http_bytes("POST", f"{url}/{fid(k)}", os.urandom(1000))[0] == 201
        for k in range(1, 21):
            assert http_bytes("GET", f"{url}/{fid(k)}")[0] == 200
        assert http_bytes("GET", f"{url}/{fid(999)}")[0] == 404
        time.sleep(0.2)
        assert _heat(vs) == (21.0, 20.0)
    finally:
        vs.stop()
