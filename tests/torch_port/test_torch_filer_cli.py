"""``python -m seaweedfs_tpu_torch filer|upload|download|delete`` in
subprocesses, over a port master and a port volume server
(``ec_backend="cpu"``) in this process.

The filer, on a sqlite ``-db`` with 1 MiB chunks and no
``SWEED_QUERY_BACKEND``: it serves a write and a read, answers
``/_status``, and keeps its entries across a restart on the same ``-db``;
with no card, a filer-side query and a ``/_select`` answer 500 naming the
device, while a single-chunk query runs on the volume server. With no
``-db``, ``filer.toml`` picks the store: ``[redis]`` over an in-process
``MiniRedisServer`` and ``[sql]`` over the stdlib ``sqlite3`` driver serve
and keep their entries across a restart; a store or a queue whose client
SDK is missing (cassandra, kafka) stops the command with a message naming
the package. ``notification.toml``'s file queue gets one event per
mutation, and the log, webhook and SQS queues start with the filer (their
collectors down, the writes go on). ``filer.sync -isActivePassive`` copies
one filer's tree into another's (and only that way), ``filer.replicate``
mirrors a subtree into a directory, and ``watch`` prints the meta events.
``upload`` splits a file past ``-maxMB`` into chunks and a manifest,
``download`` reads it back whole, and ``delete`` removes it.
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
    """A store or queue whose client SDK is not installed stops the filer
    naming the package (as the JAX package's does)."""
    master, _ = cluster
    (tmp_path / "filer.toml").write_text("[cassandra]\nenabled = true\nhosts = \"h\"\n")
    r = _cli(tmp_path, "filer", "-master", master.url, "-port", str(free_port()))
    assert r.returncode != 0 and "cassandra-driver" in r.stderr, r.stderr[-500:]
    (tmp_path / "filer.toml").write_text("[sqlite]\nenabled = true\ndbFile = \"x.db\"\n")
    (tmp_path / "notification.toml").write_text("[notification.kafka]\nenabled = true\n")
    r = _cli(tmp_path, "filer", "-master", master.url, "-port", str(free_port()))
    assert r.returncode != 0 and "kafka-python" in r.stderr, r.stderr[-500:]


@pytest.fixture(scope="module")
def redis():
    from seaweedfs_tpu_torch.util.mini_redis import MiniRedisServer

    srv = MiniRedisServer().start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("kind", ["redis", "sql"])
def test_filer_toml_store_selection(tmp_path, cluster, redis, kind):
    master, _ = cluster
    if kind == "redis":
        conf = f'[redis]\nenabled = true\naddress = "{redis.address}"\n'
    else:
        conf = (f'[sql]\nenabled = true\ndriver = "sqlite3"\n'
                f'database = "{tmp_path / "meta.sqlite"}"\ncheck_same_thread = false\n')
    (tmp_path / "filer.toml").write_text(conf)
    proc, url = _start_filer(tmp_path, master.url)
    port = int(url.split(":")[1])
    try:
        assert http_bytes("POST", f"http://{url}/toml/{kind}.txt", kind.encode())[0] == 201
        assert http_bytes("GET", f"http://{url}/toml/{kind}.txt") == (200, kind.encode())
    finally:
        _stop(proc)
    out = proc.stdout.read()
    want = "RedisStore" if kind == "redis" else "GenericSqlStore"
    assert f"(store {want})" in out, out
    assert not (tmp_path / "filer.db").exists()
    proc, url = _start_filer(tmp_path, master.url, port=port)
    try:  # the entry lives in the configured store
        assert http_bytes("GET", f"http://{url}/toml/{kind}.txt") == (200, kind.encode())
    finally:
        _stop(proc)


def test_notification_toml_file_queue(tmp_path, cluster):
    master, _ = cluster
    events = tmp_path / "events.jsonl"
    (tmp_path / "notification.toml").write_text(
        f'[notification.file]\nenabled = true\npath = "{events}"\n')
    proc, url = _start_filer(tmp_path, master.url, "-db", str(tmp_path / "f.db"))
    try:
        for i in range(3):
            assert http_bytes("POST", f"http://{url}/n/f{i}.txt", b"x")[0] == 201
        assert http_bytes("DELETE", f"http://{url}/n/f1.txt")[0] < 300
        deadline = time.time() + 10
        while time.time() < deadline:
            recs = [json.loads(x) for x in events.read_text().splitlines()] \
                if events.exists() else []
            if len(recs) >= 5:
                break
            time.sleep(0.1)
    finally:
        _stop(proc)
    assert "notifications -> FileQueue" in proc.stdout.read()
    assert [r["key"] for r in recs] == ["/n", "/n/f0.txt", "/n/f1.txt", "/n/f2.txt",
                                       "/n/f1.txt"]
    assert recs[-1]["message"]["new_entry"] is None


@pytest.mark.parametrize("queue,conf", [
    ("LogQueue", "[notification.log]\nenabled = true\n"),
    ("WebhookQueue", '[notification.webhook]\nenabled = true\nurl = "http://127.0.0.1:1/ev"\n'),
    ("SqsQueue", '[notification.aws_sqs]\nenabled = true\naws_access_key_id = "a"\n'
                 'aws_secret_access_key = "s"\nendpoint = "http://127.0.0.1:1"\n'
                 'sqs_queue_url = "http://127.0.0.1:1/1/q"\n'),
])
def test_notification_queues_start_the_filer(tmp_path, cluster, queue, conf):
    """Each queue of notification.toml starts with the filer; one whose
    collector is down loses its events, never the filer's writes."""
    master, _ = cluster
    (tmp_path / "notification.toml").write_text(conf)
    proc, url = _start_filer(tmp_path, master.url, "-db", str(tmp_path / "f.db"))
    try:
        for i in range(3):
            assert http_bytes("POST", f"http://{url}/q/f{i}.txt", b"x")[0] == 201
        assert http_bytes("GET", f"http://{url}/q/f2.txt") == (200, b"x")
    finally:
        _stop(proc)
    assert f"notifications -> {queue}" in proc.stdout.read()


def test_filer_replicate_into_a_directory(tmp_path, cluster):
    master, _ = cluster
    proc, url = _start_filer(tmp_path, master.url, "-db", str(tmp_path / "f.db"))
    rep = None
    try:
        for i in range(3):
            assert http_bytes("POST", f"http://{url}/r/sub/f{i}.txt", f"r{i}".encode())[0] == 201
        assert http_bytes("POST", f"http://{url}/elsewhere/x.txt", b"no")[0] == 201
        rep = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.replicate", "-filer", url,
             "-source", "/r", "-sink.dir", str(tmp_path / "mirror")],
            cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        mirror = tmp_path / "mirror" / "sub"
        deadline = time.time() + 60
        while time.time() < deadline and len(list(mirror.glob("f*.txt"))) < 3:
            time.sleep(0.2)
        assert http_bytes("DELETE", f"http://{url}/r/sub/f1.txt")[0] < 300
        while time.time() < deadline and (mirror / "f1.txt").exists():
            time.sleep(0.2)
    finally:
        if rep is not None:
            rep.send_signal(signal.SIGTERM)
            rep.wait(timeout=20)
        _stop(proc)
    assert sorted(p.name for p in mirror.iterdir()) == ["f0.txt", "f2.txt"]
    assert (mirror / "f2.txt").read_bytes() == b"r2"
    assert not (tmp_path / "mirror" / "elsewhere").exists()
    assert "LocalFsSink" in rep.stdout.read()


def test_filer_sync_active_passive_and_watch(tmp_path, cluster):
    master, _ = cluster
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    pa, a = _start_filer(tmp_path / "a", master.url, "-db", str(tmp_path / "a/f.db"))
    pb, b = _start_filer(tmp_path / "b", master.url, "-db", str(tmp_path / "b/f.db"))
    procs = [pa, pb]
    try:
        for i in range(3):
            assert http_bytes("POST", f"http://{a}/src/f{i}.txt", f"a{i}".encode())[0] == 201
        assert http_bytes("POST", f"http://{b}/dst/only-b.txt", b"b")[0] == 201
        sync = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.sync", "-a", a, "-b", b,
             "-a.path", "/src", "-b.path", "/dst", "-isActivePassive"],
            cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        procs.append(sync)
        watch = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "watch", "-filer", b],
            cwd=tmp_path, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        procs.append(watch)
        deadline = time.time() + 60
        while time.time() < deadline:
            if all(http_bytes("GET", f"http://{b}/dst/f{i}.txt")[0] == 200 for i in range(3)):
                break
            time.sleep(0.2)
        for i in range(3):
            assert http_bytes("GET", f"http://{b}/dst/f{i}.txt") == (200, f"a{i}".encode())
        time.sleep(0.5)
        # active-passive: nothing flows back from B
        assert http_bytes("GET", f"http://{a}/src/only-b.txt")[0] == 404
        assert http_bytes("GET", f"http://{a}/dst/only-b.txt")[0] == 404
    finally:
        for p in procs[2:]:
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=20)
        for p in procs[:2]:
            _stop(p)
    assert sync.returncode == 0
    assert "filer.sync active-passive" in sync.stdout.read()
    lines = watch.stdout.read().splitlines()
    paths = {ln.split()[2] for ln in lines if len(ln.split()) == 3}
    assert {"/dst/only-b.txt", "/dst/f0.txt", "/dst/f1.txt", "/dst/f2.txt"} <= paths, lines
    assert any(" create  /dst/f0.txt" in ln for ln in lines)


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
