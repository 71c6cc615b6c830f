"""``python -m seaweedfs_tpu_torch volume`` in a subprocess, registered with
the JAX package's master.

With ``-ec.backend=cpu`` the server answers ``/status`` and heartbeats to
the master. With the default backend (``cuda``) on a machine without a card,
``/admin/ec/generate`` answers 500 with an error that names the missing
device, and leaves no shard, index or staging file behind.
"""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from seaweedfs_tpu.server.http_util import http_bytes, http_json
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu.shell.commands import CommandEnv

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def master():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    yield m
    threading.Thread(target=m.stop, daemon=True).start()  # its stop takes ~10 s


def _start(tmp_path, master_url, *flags):
    """Start the CLI; returns (process, url) once /status answers."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-ip", "127.0.0.1",
         "-port", str(port), "-dir", str(tmp_path / "data"), "-mserver", master_url,
         "-pulseSeconds", "0.5", *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"127.0.0.1:{port}"
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"CLI exited {proc.returncode}:\n{proc.stdout.read()}")
        try:
            if http_bytes("GET", f"http://{url}/status", timeout=2)[0] == 200:
                return proc, url
        except OSError:
            time.sleep(0.2)
    _stop(proc)
    raise AssertionError("CLI never answered /status")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, proc.stdout.read()


def test_cpu_backend_serves_and_registers(tmp_path, master):
    proc, url = _start(tmp_path, master.url, "-ec.backend=cpu")
    try:
        status = http_json("GET", f"http://{url}/status")
        assert status["volumes"] == [] and status["ec"] == []
        env = CommandEnv(master.url)
        deadline = time.time() + 10
        while time.time() < deadline and not env.data_nodes():
            time.sleep(0.1)
        assert [n["url"] for n in env.data_nodes()] == [url]
        assert http_json("POST", f"http://{url}/admin/assign_volume?volume=3") == {}
        assert http_bytes("POST", f"http://{url}/3,0100000001", b"hello")[0] == 201
        assert http_bytes("GET", f"http://{url}/3,0100000001") == (200, b"hello")
    finally:
        _stop(proc)


def test_default_backend_refuses_ec_without_a_card(tmp_path, master):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs the kernel")
    proc, url = _start(tmp_path, master.url)
    try:
        assert http_json("POST", f"http://{url}/admin/assign_volume?volume=4") == {}
        assert http_bytes("POST", f"http://{url}/4,0100000001", b"x" * 5000)[0] == 201
        before = sorted(os.listdir(tmp_path / "data"))
        r = http_json("POST", f"http://{url}/admin/ec/generate?volume=4")
        assert r["_status"] == 500
        assert "CUDA device" in r["error"], r
        assert sorted(os.listdir(tmp_path / "data")) == before == ["4.dat", "4.idx"]
        # nothing was sealed either: the volume still takes writes
        assert http_bytes("POST", f"http://{url}/4,0200000001", b"y")[0] == 201
    finally:
        _stop(proc)
