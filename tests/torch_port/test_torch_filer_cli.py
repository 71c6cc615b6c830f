"""``python -m seaweedfs_tpu_torch filer|upload|download|delete`` in
subprocesses, over a port master and a port volume server
(``ec_backend="cpu"``) in this process.

The filer, on a sqlite ``-db`` with 1 MiB chunks and no
``SWEED_QUERY_BACKEND``: it serves a write and a read, answers
``/_status``, and keeps its entries across a restart on the same ``-db``;
with no card, a filer-side query and a ``/_select`` answer 500 naming the
device, while a single-chunk query runs on the volume server. A
``filer.toml`` that enables a store the port lacks, or a
``notification.toml`` that enables a queue, stops the command with a
message naming it. ``upload`` splits a file past ``-maxMB`` into chunks
and a manifest, ``download`` reads it back whole, and ``delete`` removes
it.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fcli")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    vs = VolumeServer([str(tmp / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.5, ec_backend="cpu").start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.master.topo.data_nodes():
        time.sleep(0.05)
    yield master, vs
    vs.stop()
    master.stop()


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SWEED_QUERY_BACKEND", None)
    return env


def _cli(cwd, *args, timeout=60):
    return subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args], cwd=cwd,
                          env=_env(), capture_output=True, text=True, timeout=timeout)


def _start_filer(cwd, master_url, *flags, port=None):
    port = port or free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-ip", "127.0.0.1",
         "-port", str(port), "-master", master_url, *flags],
        cwd=cwd, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"127.0.0.1:{port}"
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"filer exited {proc.returncode}:\n{proc.stdout.read()}")
        try:
            if http_bytes("GET", f"http://{url}/_status", timeout=2)[0] == 200:
                return proc, url
        except OSError:
            time.sleep(0.2)
    _stop(proc)
    raise AssertionError("the filer never answered /_status")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, proc.stdout.read()


CSV = b"id,region,score\n" + b"".join(b"%d,%s,%d\n" % (i, [b"east", b"west"][i % 2], i % 1000)
                                      for i in range(120_000))


def test_filer_serves_over_a_port_cluster(tmp_path, cluster):
    master, _ = cluster
    db = str(tmp_path / "filer.db")
    proc, url = _start_filer(tmp_path, master.url, "-db", db, "-chunkSizeMB", "1")
    try:
        assert http_bytes("POST", f"http://{url}/docs/a.txt", b"hello filer")[0] == 201
        assert http_bytes("GET", f"http://{url}/docs/a.txt") == (200, b"hello filer")
        st = http_json("GET", f"http://{url}/_status")
        assert st["master"] == master.url and st["url"] == url and st["ring"]["active"] is False
        assert http_bytes("POST", f"http://{url}/q/big.csv", CSV)[0] == 201
        assert http_bytes("POST", f"http://{url}/q/small.csv", CSV[:5000])[0] == 201
        assert len(http_json("GET", f"http://{url}/q/big.csv?meta=true")["chunks"]) > 1
        if not torch.cuda.is_available():
            req = {"path": "/q/big.csv", "input": "csv",
                   "sql": "SELECT * FROM s3object WHERE score > 990"}
            st, body = http_bytes("POST", f"http://{url}/_query", json.dumps(req).encode())
            assert st == 500 and b"CUDA device" in body, body
            st, body = http_bytes("POST", f"http://{url}/_select?path=/q/big.csv",
                                  b"<SelectObjectContentRequest><Expression>SELECT * FROM "
                                  b"s3object</Expression><InputSerialization><CSV/>"
                                  b"</InputSerialization></SelectObjectContentRequest>")
            assert st == 500 and b"CUDA device" in body, body
        req = {"path": "/q/small.csv", "input": "csv",
               "sql": "SELECT id FROM s3object WHERE score = 7"}
        st, body = http_bytes("POST", f"http://{url}/_query", json.dumps(req).encode())
        assert st == 200 and json.loads(body)["rows"] == [{"id": "7"}]
    finally:
        _stop(proc)
    # the meta log lives beside the store, per filer port (<db>.metalog.<port>)
    proc, url = _start_filer(tmp_path, master.url, "-db", db, port=int(url.split(":")[1]))
    try:  # the sqlite store and the meta log beside it survive the restart
        assert http_bytes("GET", f"http://{url}/docs/a.txt") == (200, b"hello filer")
        events = http_json("GET", f"http://{url}/_meta/events")["events"]
        assert [e["new_entry"]["full_path"] for e in events if e["new_entry"]][-1] == \
            "/q/small.csv"
    finally:
        _stop(proc)


def test_unported_store_or_queue_stops_the_filer(tmp_path, cluster):
    master, _ = cluster
    (tmp_path / "filer.toml").write_text("[redis]\nenabled = true\n")
    r = _cli(tmp_path, "filer", "-master", master.url, "-port", str(free_port()))
    assert r.returncode != 0 and "redis" in r.stderr and "not ported yet" in r.stderr
    (tmp_path / "filer.toml").write_text("[sqlite]\nenabled = true\ndbFile = \"x.db\"\n")
    (tmp_path / "notification.toml").write_text("[notification.kafka]\nenabled = true\n")
    r = _cli(tmp_path, "filer", "-master", master.url, "-port", str(free_port()))
    assert r.returncode != 0 and "kafka" in r.stderr and "not ported yet" in r.stderr


def test_upload_download_delete(tmp_path, cluster):
    master, _ = cluster
    data = os.urandom(2_500_000)
    (tmp_path / "f.bin").write_bytes(data)
    r = _cli(tmp_path, "upload", "-master", master.url, "-maxMB", "1", "f.bin")
    assert r.returncode == 0, r.stderr
    fid = r.stdout.split()[-1]
    r = _cli(tmp_path, "download", "-master", master.url, "-o", "back.bin", fid)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "back.bin").read_bytes() == data
    r = _cli(tmp_path, "delete", "-master", master.url, fid)
    assert r.returncode == 0 and "deleted 1/1" in r.stdout, r.stdout + r.stderr
    r = _cli(tmp_path, "download", "-master", master.url, "-o", "gone.bin", fid)
    assert r.returncode != 0
