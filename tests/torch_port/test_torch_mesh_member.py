"""``SWEED_MESH`` membership of the port's volume servers.

Under ``SWEED_MESH=1`` a volume server joins a ``torch.distributed`` mesh
at ``start()``, before its first heartbeat, and reports it in every beat
(``mesh``), as the JAX package's server reports its ``jax.distributed``
one. The master's fleet scheduler lists the members in ``/ec/fleet/status``
and places a fleet encode on a member among a volume's holders.

Single-process meshes run in this process beside a JAX server of the same
environment (the two report the same coordinates). The two-process mesh
runs two port volume servers as subprocesses of the CLI, forming a gloo
group; their output goes to files and each has a deadline of its own.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.ec.constants import TOTAL_SHARDS
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COORDS = ("coordinator", "process_id", "num_processes", "initialized")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def _members(master_url):
    return http_json("GET", f"http://{master_url}/ec/fleet/status")["members"]


def _fill(master_url, collection, n, rng, replication="000"):
    """n needles into one volume of ``collection``; returns (vid, {fid: data})."""
    vid, blobs = None, {}
    while len(blobs) < n:
        a = http_json("GET", f"http://{master_url}/dir/assign?collection={collection}"
                             f"&replication={replication}")
        v = int(a["fid"].split(",")[0])
        vid = v if vid is None else vid
        if v != vid:
            continue
        data = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
        assert http_bytes("POST", f"http://{a['url']}/{a['fid']}", data)[0] == 201
        blobs[a["fid"]] = data
    return vid, blobs


def _read_back(master_url, blobs):
    for fid, want in blobs.items():
        loc = http_json("GET", f"http://{master_url}/dir/lookup?volumeId={fid.split(',')[0]}")
        status, got = http_bytes("GET", f"http://{loc['locations'][0]['url']}/{fid}")
        assert status == 200 and got == want, fid


def _fleet_encode(master_url, collection, vid):
    env = CommandEnv(master_url)
    res = run_command(env, f"ec.encode -volumeId={vid} -collection={collection} -fleet")
    assert all(j["state"] == "done" for j in res["jobs"]), res
    assert _wait(lambda: len(env.ec_shard_locations(vid)) == TOTAL_SHARDS)
    return res["jobs"][0]["server"]


def test_single_process_mesh_reaches_the_master(tmp_path, monkeypatch):
    """Two replicas of a volume, one on a mesh member: the heartbeat carries
    the port member's mesh (the same coordinates as a JAX member's), and
    the fleet encode lands on the member rather than the other holder."""
    master = MasterServer(port=free_port(), node_timeout=60).start()
    plain = VolumeServer([str(tmp_path / "plain")], port=free_port(), master_url=master.url,
                         pulse_seconds=0.3, ec_backend="cpu").start()
    monkeypatch.setenv("SWEED_MESH", "1")
    member = VolumeServer([str(tmp_path / "member")], port=free_port(), master_url=master.url,
                          pulse_seconds=0.3, ec_backend="cpu").start()
    # a data center of its own: the 001 volume below needs two servers of
    # one rack, so its replicas go on the port's two
    jmember = JVolumeServer([str(tmp_path / "jmember")], port=free_port(),
                            master_url=master.url, data_center="dc2", pulse_seconds=0.3,
                            ec_backend="numpy")
    jmember.start()
    try:
        assert plain.mesh_info is None
        assert member.mesh_info == {"coordinator": "", "process_id": 0, "num_processes": 1,
                                    "initialized": True, "local_devices": 1}
        murl, jurl = f"127.0.0.1:{member.port}", f"127.0.0.1:{jmember.port}"
        assert _wait(lambda: {murl, jurl} <= set(_members(master.url)))
        members = _members(master.url)
        assert f"127.0.0.1:{plain.port}" not in members
        assert {k: members[murl][k] for k in COORDS} == {k: members[jurl][k] for k in COORDS}
        rng = np.random.default_rng(7)
        vid, blobs = _fill(master.url, "meshc", 8, rng, replication="001")
        holders = [loc["url"] for loc in http_json(
            "GET", f"http://{master.url}/dir/lookup?volumeId={vid}")["locations"]]
        assert sorted(holders) == sorted([murl, f"127.0.0.1:{plain.port}"])
        assert _fleet_encode(master.url, "meshc", vid) == murl
        _read_back(master.url, blobs)
    finally:
        jmember.stop()
        member.stop()
        plain.stop()
        master.stop()


def test_failed_rendezvous_leaves_the_server_serving(tmp_path, monkeypatch):
    """A mesh whose coordinator never answers: start() returns within the
    bounded timeout, the server serves and reports initialized=false."""
    from seaweedfs_tpu_torch.server import volume_server as vs_mod

    monkeypatch.setattr(vs_mod, "MESH_INIT_TIMEOUT_S", 2.0)
    monkeypatch.setenv("SWEED_MESH", "1")
    monkeypatch.setenv("SWEED_MESH_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("SWEED_MESH_PROCESS_ID", "1")  # rank 1: waits for rank 0
    monkeypatch.setenv("SWEED_MESH_NUM_PROCESSES", "2")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    t0 = time.monotonic()
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.3, ec_backend="cpu").start()
    try:
        assert time.monotonic() - t0 < 30
        assert vs.mesh_info["initialized"] is False and vs.mesh_info["num_processes"] == 2
        url = f"127.0.0.1:{vs.port}"
        assert _wait(lambda: url in _members(master.url))
        assert _members(master.url)[url]["initialized"] is False
        assert http_bytes("GET", f"http://{url}/status")[0] == 200
    finally:
        vs.stop()
        master.stop()


def _start_pair(tmp_path, master_url, coordinator):
    procs, logs, ports = [], [], []
    env = dict(os.environ, SWEED_MESH="1", SWEED_MESH_COORDINATOR=coordinator,
               SWEED_MESH_NUM_PROCESSES="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for rank in range(2):
        port = free_port()
        log = open(tmp_path / f"rank{rank}.log", "w+")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
             "-dir", str(tmp_path / f"r{rank}"), "-mserver", master_url,
             "-port", str(port), "-ec.backend", "cpu", "-pulseSeconds", "0.5"],
            env=dict(env, SWEED_MESH_PROCESS_ID=str(rank)), cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
        ports.append(port)
    return procs, logs, ports


def _stop(procs, logs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for log in logs:
        log.close()


def _log(log):
    log.flush()
    log.seek(0)
    return log.read()


def test_two_process_mesh_over_gloo(tmp_path):
    """Two port volume servers, ranks 0 and 1 of one gloo group: both reach
    the master's fleet status as initialized members of a 2-process mesh,
    and a fleet encode of a volume lands on its holder."""
    master = MasterServer(port=free_port(), node_timeout=60).start()
    procs, logs = [], []
    try:
        for attempt in range(2):
            procs, logs, ports = _start_pair(tmp_path, master.url,
                                             f"127.0.0.1:{free_port()}")
            urls = [f"127.0.0.1:{p}" for p in ports]

            def up():
                m = _members(master.url)
                return all(u in m for u in urls) or any(p.poll() is not None for p in procs)

            assert _wait(up, timeout=90), [_log(log)[-2000:] for log in logs]
            members = _members(master.url)
            text = "".join(_log(log) for log in logs)
            if attempt == 0 and not all(members.get(u, {}).get("initialized") for u in urls) \
                    and "address already in use" in text.lower():
                _stop(procs, logs)  # the coordinator's port was taken meanwhile
                continue
            break
        for rank, u in enumerate(urls):
            m = members[u]
            assert m["initialized"] is True, text[-3000:]
            assert (m["process_id"], m["num_processes"], m["backend"], m["local_devices"]) == (
                rank, 2, "gloo", 1)
        rng = np.random.default_rng(11)
        vid, blobs = _fill(master.url, "mesh2", 8, rng)
        holder = http_json("GET", f"http://{master.url}/dir/lookup?volumeId={vid}")[
            "locations"][0]["url"]
        assert _fleet_encode(master.url, "mesh2", vid) == holder
        _read_back(master.url, blobs)
    finally:
        _stop(procs, logs)
        master.stop()
