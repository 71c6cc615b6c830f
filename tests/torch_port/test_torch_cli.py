"""``python -m seaweedfs_tpu_torch volume|master|shell`` in subprocesses.

The volume server, registered with the JAX package's master: with
``-ec.backend=cpu`` it answers ``/status`` and heartbeats to the master.
With the default backend (``cuda``) on a machine without a card,
``/admin/ec/generate`` answers 500 with an error that names the missing
device, and leaves no shard, index or staging file behind.

The port-only cluster: a ``master`` and a ``volume`` process, then ``shell
-c`` lists the volume and the topology. ``master -peers`` elects one
leader of a pair and ``-mdir`` keeps the master's state across a restart; a
shell command the port lacks fails with exit 1, naming it as not ported
yet. On that cluster the volume maintenance runs from the
command line: ``shell -c "volume.vacuum ..."`` compacts, ``backup`` copies
the volume locally, ``volume.tail`` prints its appended needles and
``volumeServer.leave`` retires the server. The offline ``compact`` writes the
same files as the JAX package's ``compact``.
"""

import json
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


def _start_master(port, *flags):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-ip", "127.0.0.1",
         "-port", str(port), "-volumeSizeLimitMB", "64", *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    url = f"127.0.0.1:{port}"
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"master exited {proc.returncode}:\n{proc.stdout.read()}")
        try:
            if http_bytes("GET", f"http://{url}/cluster/status", timeout=2)[0] == 200:
                return proc, url
        except OSError:
            time.sleep(0.2)
    _stop(proc)
    raise AssertionError("master never answered /cluster/status")


def _shell(master_url, command):
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master", master_url,
         "-c", command],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)


def test_port_only_cluster_master_volume_shell(tmp_path):
    mproc, murl = _start_master(free_port())
    try:
        vproc, vurl = _start(tmp_path, murl, "-ec.backend=cpu")
        try:
            status = http_json("GET", f"http://{murl}/dir/status")
            assert status["is_leader"] and status["leader"] == murl
            grown = http_json("POST", f"http://{murl}/vol/grow?collection=c1&count=1")
            assert grown == {"count": 1}
            r = _shell(murl, "volume.list")
            assert r.returncode == 0, r.stdout + r.stderr
            vols = json.loads(r.stdout)
            assert [(v["collection"], v["server"]) for v in vols] == [("c1", vurl)]
            r = _shell(murl, "cluster.status; collection.list")
            assert r.returncode == 0, r.stdout + r.stderr
            assert vurl in r.stdout and '"c1"' in r.stdout
        finally:
            _stop(vproc)
    finally:
        _stop(mproc)


@pytest.mark.parametrize("flag", ["-peers", "-mdir"])
def test_master_refuses_unported_flags(flag, tmp_path):
    """Once refused as not ported, each flag now works: a ``-peers`` pair
    elects one leader that both name, and the fid-lease journal kept under
    ``-mdir`` survives a restart (the restarted master assigns past the
    leased range)."""
    if flag == "-peers":
        ports = [free_port(), free_port()]
        peers = ",".join(f"127.0.0.1:{p}" for p in ports)
        procs = [_start_master(p, "-peers", peers) for p in ports]
        try:
            def agreed():
                st = [http_json("GET", f"http://{url}/cluster/status") for _, url in procs]
                return (len({s["leader"] for s in st}) == 1 and st[0]["leader"]
                        and sum(s["is_leader"] for s in st) == 1)

            deadline = time.time() + 30
            while not agreed() and time.time() < deadline:
                time.sleep(0.2)
            assert agreed()
        finally:
            for proc, _ in procs:
                _stop(proc)
        return
    port, mdir = free_port(), str(tmp_path / "meta")
    proc, url = _start_master(port, "-mdir", mdir)
    vproc, _ = _start(tmp_path, url, "-ec.backend=cpu")
    try:
        env = CommandEnv(url)

        def lease():
            if not env.data_nodes():
                return None
            return http_json("POST", f"http://{url}/dir/fid_lease?client=t&count=64")

        deadline = time.time() + 20
        while not (r := lease()) and time.time() < deadline:
            time.sleep(0.2)
        assert r and r.get("lease_id"), r
        key = int(r["fid"].split(",")[1][:-8], 16)
        _stop(proc)
        assert sorted(os.listdir(mdir)) == [f"fid_leases_{port}.jsonl"]
        proc, url = _start_master(port, "-mdir", mdir)
        st = http_json("GET", f"http://{url}/dir/status")["fid_leases"]
        assert st["replayed_max_key"] == key + 64
        deadline = time.time() + 20
        while not env.data_nodes() and time.time() < deadline:
            time.sleep(0.2)
        a = http_json("GET", f"http://{url}/dir/assign")
        assert int(a["fid"].split(",")[1][:-8], 16) >= key + 64
    finally:
        _stop(vproc)
        _stop(proc)


@pytest.mark.parametrize("command", ["query", "fs.ls /", "volume.fsck"])
def test_shell_unported_command_fails(command):
    mproc, murl = _start_master(free_port())
    try:
        r = _shell(murl, command)
        assert r.returncode == 1, r.stdout
        assert "not ported yet" in r.stdout and command.split()[0] in r.stdout
    finally:
        _stop(mproc)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)


def test_port_only_cluster_volume_maintenance(tmp_path):
    mproc, murl = _start_master(free_port())
    try:
        vproc, vurl = _start(tmp_path, murl, "-ec.backend=cpu")
        try:
            assert http_json("POST", f"http://{murl}/vol/grow?collection=m&count=1") == \
                {"count": 1}
            a = http_json("GET", f"http://{murl}/dir/assign?collection=m")
            vid = int(a["fid"].split(",")[0])
            fids = [f"{vid},{i:x}00001234" for i in range(1, 21)]
            for i, fid in enumerate(fids):
                assert http_bytes("POST", f"http://{vurl}/{fid}", body=b"x" * (500 + i))[0] == 201
            for fid in fids[::2]:
                assert http_bytes("DELETE", f"http://{vurl}/{fid}")[0] == 202
            r = _shell(murl, "volume.vacuum -garbageThreshold=0.3")
            assert r.returncode == 0 and json.loads(r.stdout) == [vid], r.stdout + r.stderr
            r = _cli("backup", "-master", murl, "-volume", str(vid), "-dir",
                     str(tmp_path / "bk"), "-collection", "m")
            assert r.returncode == 0 and "+10 writes" in r.stdout, r.stdout + r.stderr
            r = _cli("volume.tail", "-master", murl, "-volumeId", str(vid),
                     "-timeoutSeconds", "0.5", "-pollInterval", "0.1")
            lines = r.stdout.splitlines()
            assert r.returncode == 0 and len(lines) == 10, r.stdout + r.stderr
            assert all(line.startswith(f"+ {vid},") for line in lines)
            r = _shell(murl, f"volumeServer.leave -node={vurl}")
            assert r.returncode == 0 and json.loads(r.stdout) == {"left": vurl}, r.stdout
            assert http_json("GET", f"http://{murl}/dir/status")["topology"][
                "data_centers"][0]["racks"][0]["nodes"] == []
        finally:
            _stop(vproc)
    finally:
        _stop(mproc)


def test_offline_compact_writes_the_reference_files(tmp_path):
    from seaweedfs_tpu.storage.needle import Needle
    from seaweedfs_tpu.storage.volume import Volume

    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
        v = Volume(str(tmp_path / d), "c", 4)
        for i in range(1, 31):
            v.write_needle(Needle(cookie=9, id=i, data=bytes([i]) * (100 * i)),
                           append_at_ns=1_700_000_000_000_000_000 + i)
        for i in range(1, 31, 3):
            v.delete_needle(Needle(cookie=9, id=i), append_at_ns=1_700_000_000_000_001_000 + i)
        v.close()
    r = _cli("compact", "-dir", str(tmp_path / "port"), "-collection", "c", "-volumeId", "4")
    assert r.returncode == 0 and "reclaimed" in r.stdout, r.stdout + r.stderr
    j = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu", "compact", "-dir", str(tmp_path / "jax"),
         "-collection", "c", "-volumeId", "4"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120)
    assert j.returncode == 0, j.stdout + j.stderr
    assert r.stdout == j.stdout.replace("→", "->")
    for ext in (".dat", ".idx"):
        assert (tmp_path / "port" / f"c_4{ext}").read_bytes() == \
            (tmp_path / "jax" / f"c_4{ext}").read_bytes()


_REPORT_LINE = (r"^(requests/sec: [\d,]+\.\d\d|transfer/sec: [\d,]+\.\d\d MB/s|"
                r"p(50|90|99) latency: \d+\.\d\d ms|max latency: \d+\.\d\d ms|"
                r"failed: \d+ / \d+)$")


def _report_blocks(out: str) -> dict:
    """{"write": [lines], "read": [lines]} from a benchmark's output."""
    blocks, cur = {}, None
    for line in out.splitlines():
        if line.startswith("--- ") and line.endswith(" ---"):
            cur = blocks.setdefault(line[4:-4], [])
        elif cur is not None and line and not line.startswith("reading"):
            cur.append(line)
    return blocks


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_benchmark_cli_against_a_cluster(tmp_path_factory, kind):
    """``python -m seaweedfs_tpu_torch benchmark -n 2000 -c 8`` against a
    cluster of either package (engines on): no failure, and the report's
    lines parse as the reference's do."""
    import re

    from serving_pair import pair

    with pair(tmp_path_factory, assign_vid=False) as nodes:
        master = nodes[kind].master.url
        r = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "benchmark", "-master", master,
             "-n", "2000", "-c", "8", "-deletePercent", "10"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        blocks = _report_blocks(r.stdout)
        assert set(blocks) == {"write", "delete", "read"}, r.stdout
        for name, lines in blocks.items():
            assert len(lines) == 7 and all(re.match(_REPORT_LINE, ln) for ln in lines), lines
            failed = re.match(r"failed: (\d+) / (\d+)", lines[-1])
            assert failed.group(1) == "0", (name, lines)
        assert re.match(r"failed: 0 / 2000", blocks["write"][-1])
        assert r.stdout.startswith("writing 2000 files of 1024B with concurrency 8 "
                                   "(assign batch 100) ...")
        c = nodes[kind].vs.turbo.counters()
        assert c["posts"] >= 2000 and c["gets"] >= 1700, c


def test_benchmark_flags_and_report_are_the_reference_ones(capsys):
    import types

    from seaweedfs_tpu.__main__ import _report as jreport
    from seaweedfs_tpu_torch.__main__ import _report as preport

    args = types.SimpleNamespace(size=1024)
    for lat, wall, failures in (([], 1.0, 7), ([0.001 * i for i in range(1, 200)], 2.0, 3)):
        preport("write", args, lat, wall, failures)
        port = capsys.readouterr().out
        jreport("write", args, lat, wall, failures)
        assert port == capsys.readouterr().out
        if failures == 7:
            assert "failed: 7 / 7" in port
    r = _cli("benchmark", "-h")
    j = subprocess.run([sys.executable, "-m", "seaweedfs_tpu", "benchmark", "-h"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.replace("seaweedfs_tpu_torch", "seaweedfs_tpu").split() == j.stdout.split()
